// K2: fused STFT, complex rFFT(window * frame) in natural bin order.
//
// Replaces mlx_audio_primitives_tpu/kernels/stft_radix.py::stft_pallas, both
// of its cores (_stft_radix_core, grouped emit, and _stft_radix_core_t,
// transposed emit) and the gathers that naturalize their layouts. One block
// takes one clip and a tile of FB frames; the staging, padding, packing and
// FFT are K1's (fft_common.cuh::frames_fft), and the bins go straight to the
// complex64 (B, n_bins, F) output, interleaved (re, im), frames fastest
// across threads.
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

__global__ void __launch_bounds__(mapt::kThreads)
stft_kernel(const float* __restrict__ y, long long L,
            const float* __restrict__ win,
            const float2* __restrict__ tw,
            float2* __restrict__ out,
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

  float2* ob = out + static_cast<long long>(b) * n_bins * F;
  for (int i = threadIdx.x; i < (n_bins << log_fb); i += blockDim.x) {
    const int k = i >> log_fb, f = i & (fb - 1);
    if (f0 + f < F)
      ob[static_cast<long long>(k) * F + f0 + f] = mapt::rfft_bin(buf + f * stride, k, m, tw);
  }
}

}  // namespace

extern "C" int stft_launch(const float* y, long long L, const float* win,
                           const float* tw, float* out, int B, int n_fft, int hop,
                           int F, int pad, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // FB frames per block: 8, fewer where the buffers would not fit
  int log_fb = 3;
  while (log_fb > 0 && stft_smem(n_fft, hop, 1 << log_fb) > kSmemLimit) --log_fb;
  const size_t smem = stft_smem(n_fft, hop, 1 << log_fb);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = mapt::allow_smem(reinterpret_cast<const void*>(stft_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log_m = __builtin_ctz(static_cast<unsigned>(n_fft / 2));
  const dim3 grid((F + (1 << log_fb) - 1) >> log_fb, B);
  stft_kernel<<<grid, mapt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, L, win, reinterpret_cast<const float2*>(tw),
      reinterpret_cast<float2*>(out), n_fft, log_m, hop, F, pad, mode, log_fb);
  return static_cast<int>(cudaGetLastError());
}
