// K3: fused ISTFT, spectrum -> windowed, overlap-added, normalized signal.
//
// Replaces mlx_audio_primitives_tpu/kernels/istft_fused.py::istft_pallas
// (pallas_call in _istft_grouped_core); its transposed and natural intakes
// (istft_pallas_t, istft_pallas_nat) compute the same function and are
// served by this kernel's strided intake. One block owns RB output hop-rows
// (RB*hop samples) of one clip. It walks the RB + C - 1 frames that cover
// them in batches of FB: for each batch it loads the half spectra (any
// strides, so both (B, F, n_bins) and the natural (B, n_bins, F) layout are
// read in place), runs the inverse real FFT in shared memory, and adds each
// windowed frame into a shared-memory output tile, each thread owning fixed
// tile samples (no atomics). Then it divides by the envelope and stores.
// Frames shared with the neighbouring blocks are recomputed: (C-1)/RB extra
// inverse FFTs. The imaginary parts of the DC and Nyquist bins are dropped
// (irfft semantics).
#include "fft_common.cuh"

namespace {

constexpr int kSmemLimit = 227 * 1024;
constexpr int kRowsPerBlock = 8;  // RB

__host__ __device__ inline size_t istft_smem(int n_fft, int hop, int rb, int fb) {
  return sizeof(float2) * size_t(fb) * mapt::frame_stride(n_fft / 2) +
         sizeof(float) * size_t(rb) * hop;
}

__global__ void __launch_bounds__(mapt::kThreads)
istft_kernel(const float2* __restrict__ S, long long sb, long long sf, long long sk,
             const float* __restrict__ win,
             const float2* __restrict__ tw,
             const float* __restrict__ env, long long env_len,
             float* __restrict__ out,
             int n_fft, int log_m, int hop, int F, long long T, int rb, int log_fb) {
  extern __shared__ float4 smem4[];
  const int fb = 1 << log_fb;
  const int m = 1 << log_m;
  const int stride = mapt::frame_stride(m);
  const float inv_m = 1.f / static_cast<float>(m);
  float2* buf = reinterpret_cast<float2*>(smem4);
  float* tile = reinterpret_cast<float*>(buf + fb * stride);

  const int b = blockIdx.y;
  const long long t0 = static_cast<long long>(blockIdx.x) * rb * hop;
  const int tlen = rb * hop;
  for (int u = threadIdx.x; u < tlen; u += blockDim.x) tile[u] = 0.f;

  // frames f with f*hop < t0 + tlen and f*hop + N > t0
  const long long fa = t0 < n_fft ? 0 : (t0 - n_fft) / hop + 1;
  const long long fe = min(static_cast<long long>(F), (t0 + tlen - 1) / hop + 1);
  const float2* Sb = S + b * sb;

  for (long long fs = fa; fs < fe; fs += fb) {
    const int nf = static_cast<int>(min(static_cast<long long>(fb), fe - fs));
    __syncthreads();  // the previous batch's overlap-add has read buf
    for (int i = threadIdx.x; i < (m << log_fb); i += blockDim.x) {
      const int k = i >> log_fb, f = i & (fb - 1);  // frames fastest: coalesced for sf == 1
      if (f < nf) {
        const float2* Sf = Sb + (fs + f) * sf;
        float2 x = Sf[k * sk];
        float2 y = Sf[(m - k) * sk];
        if (k == 0) {  // x = X[0], y = X[M]: real by irfft convention
          x.y = 0.f;
          y.y = 0.f;
        }
        buf[f * stride + mapt::pidx(mapt::bitrev(k, log_m))] = mapt::irfft_pack(x, y, k, inv_m, tw);
      }
    }
    __syncthreads();
    mapt::fft_inplace<true>(buf, stride, nf, log_m, tw, n_fft);
    for (int u = threadIdx.x; u < tlen; u += blockDim.x) {
      const long long t = t0 + u;
      float acc = tile[u];
      for (int f = 0; f < nf; ++f) {
        const long long n = t - (fs + f) * hop;
        if (n >= 0 && n < n_fft) {
          const float2 z = buf[f * stride + mapt::pidx(static_cast<int>(n >> 1))];
          acc += win[n] * ((n & 1) ? z.y : z.x);
        }
      }
      tile[u] = acc;
    }
  }

  float* ob = out + b * T;
  for (int u = threadIdx.x; u < tlen; u += blockDim.x) {
    const long long t = t0 + u;
    if (t < T) ob[t] = tile[u] / (t < env_len ? env[t] : 1.f);
  }
}

}  // namespace

extern "C" int istft_launch(const float* S, long long sb, long long sf, long long sk,
                            const float* win, const float* tw, const float* env,
                            long long env_len, float* out, int B, int n_fft,
                            int hop, int F, long long T, int device,
                            void* stream) {
  const int rb = kRowsPerBlock;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // FB frames per batch: 64 KB of frame buffers, at most 8 frames
  int log_fb = 3;
  while (log_fb > 0 && (size_t(sizeof(float2)) << log_fb) * mapt::frame_stride(n_fft / 2) > 64 * 1024)
    --log_fb;
  const size_t smem = istft_smem(n_fft, hop, rb, 1 << log_fb);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = mapt::allow_smem(reinterpret_cast<const void*>(istft_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log_m = __builtin_ctz(static_cast<unsigned>(n_fft / 2));
  const long long rows = (T + hop - 1) / hop;
  const dim3 grid(static_cast<unsigned>((rows + rb - 1) / rb), B);
  istft_kernel<<<grid, mapt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(S), sb, sf, sk, win,
      reinterpret_cast<const float2*>(tw), env, env_len, out, n_fft, log_m, hop, F,
      T, rb, log_fb);
  return static_cast<int>(cudaGetLastError());
}
