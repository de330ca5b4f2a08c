// K2: fused STFT, complex rFFT(window * frame) in natural bin order, and K2m,
// its magnitude emit |rFFT(window * frame)|.
//
// Replaces mlx_audio_primitives_tpu/kernels/stft_radix.py::stft_pallas, both
// of its cores (_stft_radix_core, grouped emit, and _stft_radix_core_t,
// transposed emit) and the gathers that naturalize their layouts. One block
// takes one clip and a tile of FB frames; the staging, padding, packing and
// FFT are K1's (fft_common.cuh::frames_fft), and the bins go straight to the
// (B, n_bins, F) output, frames fastest across threads.
//
// K2m replaces stft_magnitude_pallas (the same two cores with a magnitude
// naturalize). It shares every step with K2 and writes sqrt(re^2 + im^2) as
// float32: half of K2's output bytes, and at 64 x 30 s clips the output is
// two thirds of the bytes the function must move, so that is its saving.
#include "fft_common.cuh"

namespace {

constexpr int kSmemLimit = 227 * 1024;

__host__ __device__ inline int stft_seg(int n_fft, int hop, int fb) {
  return (((fb - 1) * hop + n_fft) + 3) & ~3;
}

__host__ __device__ inline size_t stft_smem(int n_fft, int hop, int fb) {
  return sizeof(float) * size_t(stft_seg(n_fft, hop, fb)) +
         sizeof(float2) * size_t(fb) * mapt::frame_stride(n_fft / 2);
}

// OUT is float2 (complex64, K2) or float (magnitude, K2m)
template <typename OUT>
__global__ void __launch_bounds__(mapt::kThreads)
stft_kernel(const float* __restrict__ y, long long L,
            const float* __restrict__ win,
            const float2* __restrict__ tw,
            OUT* __restrict__ out,
            int n_fft, int log_m, int hop, int F, int pad, int mode, int log_fb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int fb = 1 << log_fb;
  const int m = 1 << log_m;
  const int n_bins = m + 1;
  const int stride = mapt::frame_stride(m);
  float2* buf = reinterpret_cast<float2*>(smem + stft_seg(n_fft, hop, fb));
  const int b = blockIdx.y;
  const long long f0 = static_cast<long long>(blockIdx.x) * fb;

  mapt::frames_fft(y + static_cast<long long>(b) * L, L, win, tw, smem, buf,
                   n_fft, log_m, hop, f0, pad, mode, fb);

  OUT* ob = out + static_cast<long long>(b) * n_bins * F;
  for (int i = threadIdx.x; i < (n_bins << log_fb); i += blockDim.x) {
    const int k = i >> log_fb, f = i & (fb - 1);
    if (f0 + f < F) {
      const float2 v = mapt::rfft_bin(buf + f * stride, k, m, tw);
      if constexpr (sizeof(OUT) == sizeof(float2))
        ob[static_cast<long long>(k) * F + f0 + f] = v;
      else
        ob[static_cast<long long>(k) * F + f0 + f] = sqrtf(v.x * v.x + v.y * v.y);
    }
  }
}

template <typename OUT>
int launch(const float* y, long long L, const float* win, const float* tw, OUT* out,
           int B, int n_fft, int hop, int F, int pad, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // FB frames per block: 8, fewer where the buffers would not fit
  int log_fb = 3;
  while (log_fb > 0 && stft_smem(n_fft, hop, 1 << log_fb) > kSmemLimit) --log_fb;
  const size_t smem = stft_smem(n_fft, hop, 1 << log_fb);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = mapt::allow_smem(reinterpret_cast<const void*>(stft_kernel<OUT>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log_m = __builtin_ctz(static_cast<unsigned>(n_fft / 2));
  const dim3 grid((F + (1 << log_fb) - 1) >> log_fb, B);
  stft_kernel<OUT><<<grid, mapt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), out, n_fft, log_m, hop, F, pad,
      mode, log_fb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stft_launch(const float* y, long long L, const float* win,
                           const float* tw, float* out, int B, int n_fft, int hop,
                           int F, int pad, int mode, int device, void* stream) {
  return launch(y, L, win, tw, reinterpret_cast<float2*>(out), B, n_fft, hop, F, pad,
                mode, device, stream);
}

extern "C" int stft_mag_launch(const float* y, long long L, const float* win,
                               const float* tw, float* out, int B, int n_fft, int hop,
                               int F, int pad, int mode, int device, void* stream) {
  return launch(y, L, win, tw, out, B, n_fft, hop, F, pad, mode, device, stream);
}
