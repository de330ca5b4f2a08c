// K5: per-row means of the k smallest and the k largest values.
//
// Replaces mlx_audio_primitives_tpu/kernels/select_extremes.py::
// quantile_extreme_means_pallas (pallas_call in _quantile_extreme_means_impl),
// which stages a row block in VMEM and runs k argmin and k argmax passes
// over it. Here one thread owns one row: it reads the row's W values once
// and keeps two sorted register arrays, the k smallest (ascending) and the
// k largest (descending). Every insertion is a fixed sequence of
// compare-selects over all K slots, unrolled, so the arrays stay in
// registers. The sums run in ascending order for lo and descending order
// for hi, as the TPU kernel's extraction passes add them, then divide by k.
//
// Rows come through a strided 3-D view (B, R, W): spectral_contrast passes
// a band of the natural (B, n_bins, F) magnitude with rows = frames, which
// are contiguous, so neighbouring threads read neighbouring addresses and
// each load is coalesced, with no transpose copy. What bounds it on this
// card: the one read of the band (4 bytes per value) and, at K = 16, 4 K
// compare-selects per value; the design reads each value once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
select_extremes_kernel(const float* __restrict__ x, long long sb, long long sr,
                       long long sw, float* __restrict__ lo_out,
                       float* __restrict__ hi_out, int R, int W, int k_lo, int k_hi) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int b = blockIdx.y;
  const float* row = x + b * sb + r * sr;
  float lo[K], hi[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    lo[i] = __int_as_float(0x7f800000);   // +inf
    hi[i] = __int_as_float(0xff800000);   // -inf
  }
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const float v = row[w * sw];
    // sorted insertion that drops the last slot; from the top down, so
    // slot i-1 still holds its old value when slot i is decided
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      lo[i] = v < lo[i - 1] ? lo[i - 1] : (v < lo[i] ? v : lo[i]);
      hi[i] = v > hi[i - 1] ? hi[i - 1] : (v > hi[i] ? v : hi[i]);
    }
    lo[0] = v < lo[0] ? v : lo[0];
    hi[0] = v > hi[0] ? v : hi[0];
  }
  float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k_lo) s_lo += lo[i];
    if (i < k_hi) s_hi += hi[i];
  }
  const long long o = static_cast<long long>(b) * R + r;
  lo_out[o] = s_lo / static_cast<float>(k_lo);
  hi_out[o] = s_hi / static_cast<float>(k_hi);
}

template <int K>
cudaError_t launch_k(const float* x, long long sb, long long sr, long long sw,
                     float* lo, float* hi, int B, int R, int W, int k_lo, int k_hi,
                     cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  select_extremes_kernel<K><<<grid, kThreads, 0, stream>>>(x, sb, sr, sw, lo, hi, R, W,
                                                           k_lo, k_hi);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = k_lo > k_hi ? k_lo : k_hi;
  switch (k) {
#define MAPT_CASE(K) \
  case K: err = launch_k<K>(x, sb, sr, sw, lo, hi, B, R, W, k_lo, k_hi, s); break;
    MAPT_CASE(1) MAPT_CASE(2) MAPT_CASE(3) MAPT_CASE(4) MAPT_CASE(5) MAPT_CASE(6)
    MAPT_CASE(7) MAPT_CASE(8) MAPT_CASE(9) MAPT_CASE(10) MAPT_CASE(11) MAPT_CASE(12)
    MAPT_CASE(13) MAPT_CASE(14) MAPT_CASE(15) MAPT_CASE(16)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
