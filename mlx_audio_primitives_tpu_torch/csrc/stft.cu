// K2: fused STFT, complex rFFT(window * frame) in natural bin order, and K2m,
// its magnitude emit |rFFT(window * frame)|.
//
// Replaces mlx_audio_primitives_tpu/kernels/stft_radix.py::stft_pallas, both
// of its cores (_stft_radix_core, grouped emit, and _stft_radix_core_t,
// transposed emit) and the gathers that naturalize their layouts; K2m
// replaces stft_magnitude_pallas (the same two cores with a magnitude
// naturalize) and differs only in the store: sqrt(re^2 + im^2) as float32.
//
// What bounds it on this card: the output write (8 bytes per bin per frame
// for K2, 4 for K2m; at 64 x 30 s clips two thirds or more of the bytes the
// function moves) against ~5 GFLOP of FFT, so bytes. The FFT must therefore
// hide behind the stores, which a shared-memory FFT with a barrier per
// radix-4 pass did not. The design, whose front end K1 shares:
//
// - the register-resident front end of fft_common.cuh (Geometry,
//   first_pass, rexchange_passes): a group of T = M/16 threads owns one
//   frame, 16 points per thread; at n_fft 2048 three
//   passes (radix 8, 8, 16), three writes to shared memory and four barriers
//   per tile of frames, no bit-reversed scatter, twiddles from the float64
//   host table staged in shared memory once per block;
// - a tile of FT = min(16, 1024/T) frames per block of FT*T threads (512 at
//   most from n_fft 4096 on), so up to n_fft 2048 the emit stores 16 frames
//   (64 bytes for K2m, 128 for K2) of one bin contiguously, frames fastest
//   across lanes;
// - a persistent grid: each block walks tiles blockIdx.x, + gridDim.x, ...
//   over all (clip, tile) pairs, and the next tile's signal segment is
//   copied with cp.async while the current tile is transformed and stored
//   (the segment buffer is free once the first pass has read it). Tiles
//   that touch a clip's edges stage through padded_sample instead.
#include <cstdint>

#include "fft_common.cuh"

namespace {

// OUT is float2 (complex64, K2) or float (magnitude, K2m)
template <typename OUT>
__device__ __forceinline__ void store_bin(OUT* o, float2 x) {
  if constexpr (sizeof(OUT) == sizeof(float2))
    *o = x;
  else
    *o = sqrtf(x.x * x.x + x.y * x.y);
}

// The emit of one frame z (frame buffer layout): the thread owns bins
// k = k0 + J*T for J = 0, 1, .. while k <= M/2, and writes X[k] and X[M-k]
// from the one pair Z[k], Z[M-k]:
//   X[k] = E + W_N^k O,  X[M-k] = conj(E) + W_N^{M-k} conj(O) = conj(E - W_N^k O).
// k0 < T and J*T share no bit, so Z[k] sits at lo1 + rdigit_rev(J*T); for
// M-k the same split holds with lo2 = rdigit_rev(T - k0) (k0 > 0) and the
// constant rdigit_rev(M - (J+1)*T), or rdigit_rev((M - J*T) mod M) for
// k0 = 0. out_k and out_mk point at bins k0 and M-k0 of the frame's output.
template <typename OUT, int LOG_M, int J = 0>
__device__ __forceinline__ void emit_pairs(const float2* z, const float2* __restrict__ tw_g,
                                           OUT* out_k, OUT* out_mk, long long step, int k0,
                                           int lo1, int lo2) {
  constexpr int M = 1 << LOG_M, T = M >> mapt::kRegBits;
  if constexpr (J * T <= M / 2) {
    const int k = k0 + J * T;
    if (k <= M / 2) {
      constexpr int h1 = mapt::rdigit_rev(LOG_M, J * T);
      constexpr int h2_0 = mapt::rdigit_rev(LOG_M, (M - J * T) & (M - 1));
      constexpr int h2 = mapt::rdigit_rev(LOG_M, (M - (J + 1) * T) & (M - 1));
      const float2 a = z[mapt::rpidx(lo1 + h1)];
      const float2 c = z[mapt::rpidx(lo2 + (k0 ? h2 : h2_0))];
      const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
      const float dr = 0.5f * (a.x - c.x), di = 0.5f * (a.y + c.y);
      const float2 o = mapt::cmul(__ldg(tw_g + k), make_float2(di, -dr));  // W_N^k O
      store_bin(out_k + J * step, make_float2(er + o.x, ei + o.y));
      if (k < M / 2 || k == 0) store_bin(out_mk - J * step, make_float2(er - o.x, o.y - ei));
    }
    emit_pairs<OUT, LOG_M, J + 1>(z, tw_g, out_k, out_mk, step, k0, lo1, lo2);
  }
}

template <typename OUT, int LOG_M>
__global__ void __launch_bounds__(mapt::Geometry<LOG_M>::NT)
stft_kernel(const float* __restrict__ y, long long L,
            const float* __restrict__ win,
            const float2* __restrict__ tw_g,
            OUT* __restrict__ out,
            int hop, int F, int pad, int mode, int tiles, int total) {
  using G = mapt::Geometry<LOG_M>;
  constexpr int M = G::M, T = G::T, FT = G::FT, NT = G::NT, FS = G::FS;
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float2* twp = buf + G::TW_OFF;
  float* seg = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + G::SEG_OFF_BYTES);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const int tid = threadIdx.x;
  const int fs = tid / T, t = tid % T;
  const int seg_len = (FT - 1) * hop + 2 * M;

  static_assert(mapt::rtw_offset(LOG_M, mapt::plan_passes(LOG_M)) <= M, "twiddle tables fit");
  mapt::stage_twiddles<LOG_M>(twp, tw_g, tid, NT);
  int tile = blockIdx.x;
  int off = mapt::stage_segment(y + static_cast<long long>(tile / tiles) * L, L,
                                static_cast<long long>(tile % tiles) * FT * hop - pad, seg_len,
                                mode, seg, tid, NT);
  mapt::cp_async_wait_all();
  __syncthreads();

  for (; tile < total; tile += gridDim.x) {
    const int b = tile / tiles;
    const int f0 = (tile % tiles) * FT;
    float2* fb = buf + fs * FS;
    float2 v[mapt::kRegPoints];
    // pass 0 reads the packed, windowed frame straight from the segment
    // (float2 reads unless an odd clip length left the segment odd-aligned)
    const float* fr = seg + off + fs * hop;
    if (off & 1)
      mapt::first_pass<LOG_M, false>(v, fr, win2, fb, twp, t);
    else
      mapt::first_pass<LOG_M, true>(v, fr, win2, fb, twp, t);
    // the later passes, each group of frames behind its own barriers
    mapt::rexchange_passes<LOG_M, 1, G::GT>(fb, v, twp, t, G::GT ? tid / G::GT : 0);
    __syncthreads();
    // every frame is transformed and the segment is free: copy the next
    // tile's while this one is stored
    const int next = tile + gridDim.x;
    if (next < total)
      off = mapt::stage_segment(y + static_cast<long long>(next / tiles) * L, L,
                                static_cast<long long>(next % tiles) * FT * hop - pad,
                                seg_len, mode, seg, tid, NT);

    // emit: frames fastest across lanes, so a warp stores FT frames of a bin
    const int f = tid & (FT - 1);
    if (f0 + f < F) {
      const int k0 = tid >> G::LOG_FT;  // NT / FT = T threads per frame
      OUT* ob = out + static_cast<long long>(b) * (M + 1) * F + f0 + f;
      emit_pairs<OUT, LOG_M>(buf + f * FS, tw_g, ob + static_cast<long long>(k0) * F,
                             ob + static_cast<long long>(M - k0) * F,
                             static_cast<long long>(T) * F, k0, mapt::rdigit_rev(LOG_M, k0),
                             k0 ? mapt::rdigit_rev(LOG_M, T - k0) : 0);
    }
    mapt::cp_async_wait_all();
    __syncthreads();
  }
}

// Open both instances of LOG_M to the whole 227 KB once per device; the
// blocks a launch keeps resident follow from the shared memory it asks for.
constexpr int kMaxDevices = 64;

template <int LOG_M>
cudaError_t open_smem(int device) {
  static bool opened[kMaxDevices];
  if (opened[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(stft_kernel<float2, LOG_M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, mapt::kSmemLimit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stft_kernel<float, LOG_M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, mapt::kSmemLimit);
  opened[device] = err == cudaSuccess;
  return err;
}

// Per device: the grid of the last shared-memory size launched (SMs times
// resident blocks), so the occupancy query runs once per size, not per call
template <typename OUT, int LOG_M>
int launch_m(const float* y, long long L, const float* win, const float* tw, OUT* out,
             int B, int hop, int F, int pad, int mode, int device, cudaStream_t stream) {
  using G = mapt::Geometry<LOG_M>;
  static size_t sized[kMaxDevices];
  static int slots[kMaxDevices];
  const size_t smem = G::smem(hop);
  if (smem > mapt::kSmemLimit || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (sized[device] != smem) {
    int per_sm = 0, sms = 0;
    cudaError_t err = open_smem<LOG_M>(device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stft_kernel<OUT, LOG_M>,
                                                          G::NT, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[device] = sms * per_sm;
    sized[device] = smem;
  }
  const int tiles = (F + G::FT - 1) / G::FT;
  const long long total = static_cast<long long>(B) * tiles;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(total < slots[device] ? total : slots[device]);
  stft_kernel<OUT, LOG_M><<<grid, G::NT, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), out, hop, F, pad, mode, tiles,
      static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

// info = {threads per block, frames per tile, dynamic shared memory per
// block, resident blocks per SM for K2, the same for K2m}
template <int LOG_M>
int geometry_m(int hop, int device, int* info) {
  using G = mapt::Geometry<LOG_M>;
  const size_t smem = G::smem(hop);
  info[0] = G::NT;
  info[1] = G::FT;
  info[2] = static_cast<int>(smem);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = open_smem<LOG_M>(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], stft_kernel<float2, LOG_M>,
                                                        G::NT, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], stft_kernel<float, LOG_M>,
                                                        G::NT, smem);
  return static_cast<int>(err);
}

template <typename OUT>
int launch(const float* y, long long L, const float* win, const float* tw, OUT* out,
           int B, int n_fft, int hop, int F, int pad, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
    case 6: return launch_m<OUT, 6>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    case 7: return launch_m<OUT, 7>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    case 8: return launch_m<OUT, 8>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    case 9: return launch_m<OUT, 9>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    case 10: return launch_m<OUT, 10>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    case 11: return launch_m<OUT, 11>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    case 12: return launch_m<OUT, 12>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

extern "C" int stft_geometry(int n_fft, int hop, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
    case 6: return geometry_m<6>(hop, device, info);
    case 7: return geometry_m<7>(hop, device, info);
    case 8: return geometry_m<8>(hop, device, info);
    case 9: return geometry_m<9>(hop, device, info);
    case 10: return geometry_m<10>(hop, device, info);
    case 11: return geometry_m<11>(hop, device, info);
    case 12: return geometry_m<12>(hop, device, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
