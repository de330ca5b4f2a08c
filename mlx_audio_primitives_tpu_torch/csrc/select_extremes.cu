// K5: per-row means of the k smallest and the k largest values.
//
// Replaces mlx_audio_primitives_tpu/kernels/select_extremes.py::
// quantile_extreme_means_pallas (pallas_call in _quantile_extreme_means_impl),
// which stages a row block in VMEM and runs k argmin and k argmax passes
// over it.
//
// Rows come through a strided 3-D view (B, R, W), flattened to B*R rows on
// grid x with a 64-bit row index, so one launch takes any number of clips.
// spectral_contrast passes a band of the natural (B, n_bins, F) magnitude
// with rows = frames, which are contiguous: a thread owns a row and streams
// its W values, and the 32 neighbouring rows of a warp read each bin as one
// run of 32 floats, in place, with no transpose copy.
//
// Each thread keeps two sorted register arrays of K = max(k_lo, k_hi) slots,
// the K smallest ascending and the K largest descending. For K <= 4 it
// inserts each value v by min/max, two instructions a slot, from the top
// slot down:
//   lo[i] = max(lo[i-1], min(lo[i], v)),  hi[i] = min(hi[i-1], max(hi[i], v)),
// and slot 0 by one min (max); this is the sorted insertion that drops the
// last slot. For K >= 5 it loads K' values (K' the power of two >= K), sorts
// them with a bitonic network and merges them into both arrays (below):
// about 17 min/max a value at K = 9 against the insertion's 4K - 2 = 34.
// Both load a chunk of values before they use any, so that many
// independent loads are in flight.
//
// NaN. fminf/fmaxf return the other operand of a NaN. In the insertion, the
// operand order above makes a NaN v leave both arrays unchanged at no cost
// (the inner min or max returns the slot itself and the outer one keeps
// it), while min(lo[i], max(lo[i-1], v)) would copy lo[i-1] into slot i. A
// sorting network would turn a NaN into a copy of its neighbour, so a chunk
// whose sum is NaN (a NaN, or +inf with -inf) is inserted value by value
// instead, and its NaNs counted (the sum of every chunk, seven adds for
// eight values at K <= 4, finds the few chunks that need the count). The
// arrays thus hold the extremes of the values that are not NaN, and the
// count sets the means as the plain twin (topk, which ranks a NaN above
// +inf) and the JAX package (jnp.sort, NaN last) give them: hi is NaN for a
// row that holds a NaN, lo where fewer than k_lo values are not NaN.
//
// Merge. To merge a sorted run b of K' values into a (padded to K' with
// +inf), keep c[i] = min(a[i], b[K'-1-i]), a bitonic sequence that holds
// the K' smallest of both, and sort it with the bitonic merge network; the
// hi side does the same with min and max exchanged. Every index into a
// register array is a compile-time constant after unrolling, so the arrays
// stay in registers.
//
// The thread sums lo from slot 0 up and hi from slot 0 down the values (the
// TPU kernel's extraction passes add them in these orders), then divides by
// k. Equal values have equal bits whatever order they arrived in, so kernel
// and plain twin agree bit for bit, ties included.
//
// What bounds it on this card: the one read of the band (4 bytes a value)
// and the min/max a value, which issue at 64 lanes a clock per SM on sm_90
// (compare, minimum and maximum run at half the FP32 rate). On an H100
// 80GB HBM3 at 700 W the widest default contrast band of 64 x 30 s clips
// (W 431, k 9) takes 0.067 ms against 0.043 ms for its bytes (chip_smoke.py,
// phase 5). Rows split across four lanes merged by shuffles were slower on
// every default band there.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 8;  // loads a thread issues before their insertions (K <= 4)

__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}
__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Insert v into lo (ascending) and hi (descending); a NaN changes nothing.
template <int K>
__device__ __forceinline__ void insert(float (&lo)[K], float (&hi)[K], float v) {
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    lo[i] = fmaxf(lo[i - 1], fminf(lo[i], v));
    hi[i] = fminf(hi[i - 1], fmaxf(hi[i], v));
  }
  lo[0] = fminf(lo[0], v);
  hi[0] = fmaxf(hi[0], v);
}

// a <- the K smallest (kLo, a ascending) or largest (a descending) of a and
// b, a run of KP = pow2_ceil(K) values sorted as a is: the half-cleaner
// against b reversed, then the bitonic merge network.
template <bool kLo, int K, int KP>
__device__ __forceinline__ void merge_into(float (&a)[K], const float (&b)[KP]) {
  static_assert(KP == pow2_ceil(K), "a run of K' values");
  float c[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    const float u = b[KP - 1 - i];
    c[i] = i < K ? (kLo ? fminf(a[i], u) : fmaxf(a[i], u)) : u;  // a's padding loses
  }
#pragma unroll
  for (int l = log2_of(KP) - 1; l >= 0; --l) {
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      if ((i >> l) & 1) continue;
      const float u = c[i], w = c[i + (1 << l)];
      c[i] = kLo ? fminf(u, w) : fmaxf(u, w);
      c[i + (1 << l)] = kLo ? fmaxf(u, w) : fminf(u, w);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = c[i];
}

// Sort N (a power of two) values ascending: the bitonic sorting network.
template <int N>
__device__ __forceinline__ void sort_ascending(float (&v)[N]) {
#pragma unroll
  for (int lk = 1; lk <= log2_of(N); ++lk) {
#pragma unroll
    for (int lj = log2_of(N) - 1; lj >= 0; --lj) {
      if (lj >= lk) continue;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ (1 << lj);
        if (l < i) continue;
        const float u = fminf(v[i], v[l]), w = fmaxf(v[i], v[l]);
        const bool up = ((i >> lk) & 1) == 0;  // the last stage sorts all ascending
        v[i] = up ? u : w;
        v[l] = up ? w : u;
      }
    }
  }
}

// Merge a chunk of KP values that holds no NaN into lo and hi.
template <int K, int KP>
__device__ __forceinline__ void merge_chunk(float (&lo)[K], float (&hi)[K], float (&v)[KP]) {
  sort_ascending(v);
  merge_into<true>(lo, v);
  float r[KP];  // descending, as hi is
#pragma unroll
  for (int j = 0; j < KP; ++j) r[j] = v[KP - 1 - j];
  merge_into<false>(hi, r);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
select_extremes_kernel(const float* __restrict__ x, long long sb, long long sr,
                       long long sw, float* __restrict__ lo_out,
                       float* __restrict__ hi_out, long long rows, int R, int W,
                       int k_lo, int k_hi) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const long long b = row / R;
  const float* p = x + b * sb + (row - b * R) * sr;

  float lo[K], hi[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    lo[i] = pos_inf();
    hi[i] = neg_inf();
  }
  // K >= 5: chunks of K' values, sorted and merged; else chunks of kDepth
  // values, inserted. A chunk whose sum is NaN (a NaN, or +inf with -inf)
  // is inserted value by value and its NaNs counted, as are the tail's.
  constexpr bool kSortMerge = K >= 5;
  constexpr int D = kSortMerge ? pow2_ceil(K) : kDepth;
  int t = 0, nans = 0;
  for (; t + D <= W; t += D) {
    float v[D];
#pragma unroll
    for (int u = 0; u < D; ++u) v[u] = __ldg(p + u * sw);
    p += D * sw;
    float sum = v[0];
#pragma unroll
    for (int u = 1; u < D; ++u) sum += v[u];
    if (sum == sum) {
      if constexpr (kSortMerge) {
        merge_chunk(lo, hi, v);
        continue;
      }
    } else {
#pragma unroll
      for (int u = 0; u < D; ++u) nans += v[u] != v[u];
    }
#pragma unroll
    for (int u = 0; u < D; ++u) insert(lo, hi, v[u]);
  }
  for (; t < W; ++t, p += sw) {
    const float x = __ldg(p);
    nans += x != x;
    insert(lo, hi, x);
  }

  float s_lo = lo[0], s_hi = hi[0];
#pragma unroll
  for (int i = 1; i < K; ++i) {
    if (i < k_lo) s_lo += lo[i];
    if (i < k_hi) s_hi += hi[i];
  }
  // the twin's topk ranks a NaN above +inf: it is among the k_hi largest,
  // and among the k_lo smallest only when fewer than k_lo values are not NaN
  const float nan = __int_as_float(0x7fffffff);
  lo_out[row] = W - nans < k_lo ? nan : s_lo / static_cast<float>(k_lo);
  hi_out[row] = nans ? nan : s_hi / static_cast<float>(k_hi);
}

template <int K>
cudaError_t launch_k(const float* x, long long sb, long long sr, long long sw, float* lo,
                     float* hi, long long rows, int R, int W, int k_lo, int k_hi,
                     cudaStream_t stream) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  select_extremes_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, sb, sr, sw, lo, hi, rows, R, W, k_lo, k_hi);
  return cudaGetLastError();
}

}  // namespace

// k_lo, k_hi in [1, 16] and <= W (the wrapper's gate); one instantiation per
// K = max(k_lo, k_hi), so no slot is carried that no sum reads.
extern "C" int select_extremes_launch(const float* x, long long sb, long long sr,
                                      long long sw, float* lo, float* hi, int B, int R,
                                      int W, int k_lo, int k_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * R;
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k_lo > k_hi ? k_lo : k_hi) {
#define MAPT_CASE(K) \
  case K: return static_cast<int>(launch_k<K>(x, sb, sr, sw, lo, hi, rows, R, W, k_lo, k_hi, s));
    MAPT_CASE(1) MAPT_CASE(2) MAPT_CASE(3) MAPT_CASE(4) MAPT_CASE(5) MAPT_CASE(6)
    MAPT_CASE(7) MAPT_CASE(8) MAPT_CASE(9) MAPT_CASE(10) MAPT_CASE(11) MAPT_CASE(12)
    MAPT_CASE(13) MAPT_CASE(14) MAPT_CASE(15) MAPT_CASE(16)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
