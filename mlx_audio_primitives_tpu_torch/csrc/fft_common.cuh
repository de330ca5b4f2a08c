// Shared device code of the port's FFT kernels (K1 mel_fused, K2 stft,
// K3 istft_fused): padded signal reads, an in-place FFT over a batch of
// frames in shared memory, and the real-input split.
//
// Real FFT of N points (N a power of two) through one complex FFT of
// M = N/2 points: z[n] = x[2n] + i*x[2n+1], Z = FFT_M(z), then
//   X[k] = E[k] + W_N^k O[k],  E[k] = (Z[k] + conj Z[M-k]) / 2,
//                              O[k] = (Z[k] - conj Z[M-k]) / (2i).
// The inverse runs the same identities backwards. All arithmetic is FP32;
// twiddles come from a host table (`kernels/dft.py::rfft_twiddles`,
// tw[k] = exp(-2*pi*i*k/N) for k = 0..N/2, built in float64), so no kernel
// evaluates a transcendental. Build without --use_fast_math.
//
// Shared-memory layout of a frame buffer: point p of frame f sits at
// buf[f * frame_stride(M) + pidx(p)]. pidx inserts one float2 of padding
// every 32 points, which spreads the bit-reversed and power-of-two-strided
// accesses of the FFT over the banks.
#pragma once

#include <cuda_runtime.h>

namespace mapt {

constexpr int kThreads = 256;  // every FFT kernel runs 256-thread blocks

static __host__ __device__ __forceinline__ int pidx(int p) { return p + (p >> 5); }

static __host__ __device__ __forceinline__ int frame_stride(int m) {
  return m + (m >> 5) + 1;
}

// y[i] of one clip with NumPy padding semantics outside [0, L).
// mode: 0 constant (zeros), 1 reflect (period 2(L-1)), 2 edge.
static __device__ __forceinline__ float padded_sample(
    const float* __restrict__ y, long long L, long long i, int mode) {
  if (i >= 0 && i < L) return y[i];
  if (mode == 0 || L == 0) return 0.f;
  if (mode == 2) return y[i < 0 ? 0 : L - 1];
  if (L == 1) return y[0];
  const long long period = 2 * (L - 1);
  long long m = i % period;
  if (m < 0) m += period;
  return y[m < L ? m : period - m];
}

static __device__ __forceinline__ int bitrev(int n, int log_m) {
  return static_cast<int>(__brev(static_cast<unsigned>(n)) >> (32 - log_m));
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// In-place iterative DIT FFT of `nf` frames of M = 2^log_m points (frame f
// at buf[f * stride], points at pidx offsets). Input must sit in
// bit-reversed order and be visible to all threads (caller syncs). Radix-4
// passes, each two radix-2 stages on four points held in registers, then
// one radix-2 stage when log_m is odd. INVERSE uses conjugate twiddles and
// does not scale. Ends with __syncthreads().
template <bool INVERSE>
static __device__ void fft_inplace(float2* buf, int stride, int nf, int log_m,
                                   const float2* __restrict__ tw, int n_fft) {
  int s = 0;
  for (; s + 1 < log_m; s += 2) {
    const int h = 1 << s;
    const int quarter_log = log_m - 2;  // radix-4 butterflies per frame: M/4
    const int total = nf << quarter_log;
    const int step1 = n_fft >> (s + 1);  // W_{2h}^j = tw[j * N/(2h)]
    const int step2 = n_fft >> (s + 2);  // W_{4h}^j = tw[j * N/(4h)]
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int f = b >> quarter_log;
      const int bb = b & ((1 << quarter_log) - 1);
      const int j = bb & (h - 1);
      const int i0 = ((bb >> s) << (s + 2)) + j;
      float2 w1 = tw[j * step1];
      float2 w2 = tw[j * step2];
      if (INVERSE) {
        w1.y = -w1.y;
        w2.y = -w2.y;
      }
      // W_{4h}^{j+h} = w2 * W_4^1: -i forward, +i inverse
      const float2 w3 = INVERSE ? make_float2(-w2.y, w2.x) : make_float2(w2.y, -w2.x);
      float2* base = buf + f * stride;
      const float2 a0 = base[pidx(i0)];
      const float2 a1 = base[pidx(i0 + h)];
      const float2 a2 = base[pidx(i0 + 2 * h)];
      const float2 a3 = base[pidx(i0 + 3 * h)];
      const float2 t1 = cmul(w1, a1);
      const float2 t3 = cmul(w1, a3);
      const float2 b0 = cadd(a0, t1), b1 = csub(a0, t1);
      const float2 b2 = cadd(a2, t3), b3 = csub(a2, t3);
      const float2 u2 = cmul(w2, b2);
      const float2 u3 = cmul(w3, b3);
      base[pidx(i0)] = cadd(b0, u2);
      base[pidx(i0 + h)] = cadd(b1, u3);
      base[pidx(i0 + 2 * h)] = csub(b0, u2);
      base[pidx(i0 + 3 * h)] = csub(b1, u3);
    }
    __syncthreads();
  }
  if (s < log_m) {  // odd log_m: one radix-2 stage
    const int h = 1 << s;
    const int half_log = log_m - 1;
    const int total = nf << half_log;
    const int step = n_fft >> (s + 1);
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int f = b >> half_log;
      const int bb = b & ((1 << half_log) - 1);
      const int j = bb & (h - 1);
      const int i0 = ((bb >> s) << (s + 1)) + j;
      float2 w = tw[j * step];
      if (INVERSE) w.y = -w.y;
      float2* base = buf + f * stride;
      const float2 a = base[pidx(i0)];
      const float2 t = cmul(w, base[pidx(i0 + h)]);
      base[pidx(i0)] = cadd(a, t);
      base[pidx(i0 + h)] = csub(a, t);
    }
    __syncthreads();
  }
}

// K1 and K2's front end: stage the signal segment of frames f0 .. f0+nf-1
// ((nf-1)*hop + N samples, centre padding applied on the fly) in `seg`,
// then window, pack and bit-reverse each frame into `buf` and FFT it.
// Frame f is the segment at offset f*hop, so framing is index math. Ends
// with __syncthreads(); `seg` is free afterwards.
static __device__ void frames_fft(const float* __restrict__ yb, long long L,
                                  const float* __restrict__ win,
                                  const float2* __restrict__ tw, float* seg,
                                  float2* buf, int n_fft, int log_m, int hop,
                                  long long f0, int pad, int mode, int nf) {
  const int m = 1 << log_m;
  const int stride = frame_stride(m);
  const int seg_len = (nf - 1) * hop + n_fft;
  const long long s0 = f0 * hop - pad;
#pragma unroll 4
  for (int i = threadIdx.x; i < seg_len; i += blockDim.x)
    seg[i] = padded_sample(yb, L, s0 + i, mode);
  __syncthreads();
  for (int i = threadIdx.x; i < (nf << log_m); i += blockDim.x) {
    const int f = i >> log_m, n = i & (m - 1);
    const float2 x = *reinterpret_cast<const float2*>(seg + f * hop + 2 * n);  // hop is even
    buf[f * stride + pidx(bitrev(n, log_m))] =
        make_float2(win[2 * n] * x.x, win[2 * n + 1] * x.y);
  }
  __syncthreads();
  fft_inplace<false>(buf, stride, nf, log_m, tw, n_fft);
}

// Bin k (0 <= k <= M) of the real FFT from the packed complex FFT z of
// one frame (pidx layout).
static __device__ __forceinline__ float2 rfft_bin(const float2* z, int k, int m,
                                                  const float2* __restrict__ tw) {
  const float2 a = z[pidx(k & (m - 1))];
  const float2 b = z[pidx((m - k) & (m - 1))];
  const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
  const float dr = 0.5f * (a.x - b.x), di = 0.5f * (a.y + b.y);
  // O = d / i = (di, -dr); X = E + W * O
  const float2 o = cmul(tw[k], make_float2(di, -dr));
  return make_float2(er + o.x, ei + o.y);
}

// Packed inverse input Z[k] (0 <= k < M) from half-spectrum bins x = X[k],
// y = X[M-k]; the 1/M of the inverse transform is folded in. The caller has
// zeroed the imaginary parts of X[0] and X[M] (irfft semantics).
static __device__ __forceinline__ float2 irfft_pack(float2 x, float2 y, int k,
                                                    float inv_m,
                                                    const float2* __restrict__ tw) {
  const float er = 0.5f * (x.x + y.x), ei = 0.5f * (x.y - y.y);
  const float dr = 0.5f * (x.x - y.x), di = 0.5f * (x.y + y.y);
  const float2 w = tw[k];
  // O = d * conj(W); Z = E + i*O
  const float2 o = cmul(make_float2(dr, di), make_float2(w.x, -w.y));
  return make_float2((er - o.y) * inv_m, (ei + o.x) * inv_m);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
static inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mapt
