// K4: overlap-add of windowed frames with the envelope divide.
//
// Replaces mlx_audio_primitives_tpu/kernels/overlap_add.py::overlap_add_pallas
// (pallas_call in _pallas_forward). Output-centric: one thread computes one
// output sample t of one clip, summing the <= C = ceil(N/hop) frames that
// cover it (frames past the output are never read), then divides by the
// envelope, which counts as 1.0 past its length. Any hop; no atomics.
// Grid y holds the clip; the launcher covers any number of clips in
// launches of at most kMaxGridY clips each.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
overlap_add_kernel(const float* __restrict__ fw, const float* __restrict__ env,
                   long long env_len, float* __restrict__ out, int F, int n_fft,
                   int hop, long long T) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.y;
  const float* fb = fw + static_cast<long long>(b) * F * n_fft;
  const long long f_lo = t < n_fft ? 0 : (t - n_fft) / hop + 1;
  const long long f_hi = min(static_cast<long long>(F) - 1, t / hop);
  float acc = 0.f;
  for (long long f = f_lo; f <= f_hi; ++f) acc += fb[f * n_fft + (t - f * hop)];
  out[static_cast<long long>(b) * T + t] = acc / (t < env_len ? env[t] : 1.f);
}

}  // namespace

extern "C" int overlap_add_launch(const float* fw, const float* env, long long env_len,
                                  float* out, int B, int F, int n_fft, int hop,
                                  long long T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {  // clips b0 .. b0 + grid y - 1
    const dim3 grid(static_cast<unsigned>((T + kThreads - 1) / kThreads),
                    B - b0 < kMaxGridY ? B - b0 : kMaxGridY);
    overlap_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        fw + static_cast<long long>(b0) * F * n_fft, env, env_len, out + b0 * T, F, n_fft,
        hop, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return static_cast<int>(err);
}

// Message for an error code a launcher returned (one definition for the
// whole library; this file has no other dependency).
extern "C" const char* mapt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
