// K1m: K1's mixed-radix entry, |rFFT(window * frame)|^p @ W at an n_fft
// that is not a power of two, at any hop (Whisper's n_fft 400 = 2^4 * 5^2 at
// hop 160, which does not divide it).
//
// Replaces the same pallas_call as K1 (mlx_audio_primitives_tpu/kernels/
// mel_fused.py::melspectrogram_pallas, in _mel_radix_core). The JAX kernel,
// and K1's other entries (csrc/mel_fused.cu), run only on the radix gate
// (power-of-two n_fft that a multiple-of-128 hop divides), so at Whisper's
// shape the port took the plain composition: pad, frame, window, rfft,
// |X|^2 and an FP32 matmul, each through device memory. The port's own gate
// (kernels/mel_fused.py::mel_shape_ok) admits this entry's shapes beside the
// radix gate's; kernels/mel_fused.py::melspectrogram_fused launches it there.
//
// What bounds it on this card. At 64 x 30 s of 16 kHz audio (192,064 frames
// of 400, 128 mels) the work is 123 MB of audio read and 98 MB of mel written
// (0.066 ms at 3.35 TB/s) and ~2 GFLOP of FP32 FFT, powers and band products
// (0.03 ms at 67 TFLOP/s): bytes. What a kernel can do is keep frames,
// spectra and power rows out of device memory, and every pass of the FFT,
// which goes through shared memory, free of bank conflicts. Per tile of 32
// frames (a warp's lanes):
//
// - one segment of 31 * hop + n_fft samples, staged with cp.async (the next
//   tile's during this tile's later passes and contraction); frames are read
//   from it at offsets of hop, so the hop need not divide n_fft;
// - the real FFT of n_fft points as the complex FFT of M = n_fft / 2 packed
//   points z[n] = x[2n] + i x[2n+1] (fft_common.cuh's mixed passes: radix 5,
//   5, 8 at M = 200), in FP32, a butterfly a thread at a time, in place in
//   the frame's buffer. Pass 0 reads the windowed points from the segment
//   with butterflies fastest across lanes (neighbouring samples); the later
//   passes and the power rows take frames fastest across lanes, so that a
//   warp reads one point of 32 frames whose buffers lie an odd number of
//   float2 apart (no bank conflict) and one broadcast twiddle;
// - |X[k]|^p and |X[M-k]|^p from Z[k] and Z[M-k] (the real split, as K1's
//   power_pairs), split into bf16 hi = bf16(p) and lo = bf16(p - hi) and
//   written as rows laid out [bin pair][frame], 36 words from one bin pair to
//   the next: the writes (32 frames of one bin) and the mma B fragment loads
//   (8 frames by 4 bin pairs) both hit 32 banks. The rows lie apart from the
//   frame buffers; bins past M stay zero from the start;
// - the contraction as K1's fast entry computes it, from the same plan
//   (csrc/k1_plan.cuh, kernels/mel_fused.py::plan_of: W^T
//   split into bf16 hi and lo in the A fragments' order, each 16-column
//   m-tile's band of 16-bin k-steps): lo*hi + hi*lo + hi*hi on mma.sync
//   m16n8k16, each k-step from zero, added in FP32. A warp takes whole
//   (m-tile, 8-frame n-tile) units, so no partial sums meet in shared memory.
//   A tile whose powers hold a value that is not finite takes every k-step,
//   so that inf * 0 gives NaN in every column, as in the dense product.
//
// tests/test_torch_port_whisper.py holds the twin (the same passes in torch)
// against torch.fft.rfft; the card tests hold this kernel against the twin.
#include <cstdint>

#include <cuda_bf16.h>

#include "fft_common.cuh"
#include "k1_plan.cuh"

namespace {

constexpr int kMaxDevices = 64;
// The tile at n_fft N, and the byte offsets of its shared memory: frame
// buffers, the power rows (hi, then lo), the passes' twiddles, the bins'
// positions after the passes, the tile's flag, the segment
template <int N>
struct MixedGeometry {
  static constexpr int M = N / 2;
  static constexpr int P = mapt::mixed_passes(M);
  static constexpr int FT = 32;  // frames a tile: a warp's lanes
  // threads a block: two blocks an SM at hop 160 (105 KB each). At 64 x 30 s
  // K1m read 0.340 ms with 256 threads, 0.338 with 384 and 0.312 with 512
  // (NVIDIA H100 80GB HBM3, 700 W): 512 is the faster form, and PERF.md §7
  // lists taking it as a regression still to undo
  static constexpr int NT = 256;
  static constexpr int NW = NT / 32;
  static constexpr int FS = M | 1;  // float2 from one frame's buffer to the next: odd
  static constexpr int KSTEPS = (M + 1 + 15) / 16;
  static constexpr int WORDS = 8 * KSTEPS;  // bf16 pairs a row
  static constexpr int RS = FT + 4;         // words from one bin pair to the next
  static constexpr int ROWS_OFF = FT * FS * 8;
  static constexpr int TW_OFF = ROWS_OFF + 2 * WORDS * RS * 4;
  static constexpr int POS_OFF = TW_OFF + ((8 * mapt::mixed_tw_offset(M, P) + 15) & ~15);
  static constexpr int FLAG_OFF = POS_OFF + ((4 * M + 15) & ~15);
  static constexpr int SEG_OFF = FLAG_OFF + 16;
  static_assert(M % 2 == 0, "an even number of packed points");
  static_assert(RS % 16 == 4 && RS >= FT, "8 x 2q + g covers 32 banks");
  // the segment holds (FT - 1) * hop + N samples, 3 more for stage_segment's
  // shift, rounded to whole float4s
  static __host__ __device__ size_t smem(int hop) {
    const long long cap = ((FT - 1) * static_cast<long long>(hop) + N + 3 + 3) & ~3LL;
    return SEG_OFF + sizeof(float) * static_cast<size_t>(cap);
  }
};

// Pass 0 of every frame of the tile: the windowed packed points from the
// segment (frame f at seg + f * hop), butterflies fastest across lanes; the
// frame's points as float2 where the frame is 8-byte aligned
template <int N>
__device__ __forceinline__ void mixed_first_pass(float2* buf, const float* seg, int hop,
                                                 const float* __restrict__ win,
                                                 const float2* twp, int tid) {
  using G = MixedGeometry<N>;
  constexpr int M = G::M, R = mapt::mixed_radix(M, 0), S = mapt::mixed_stride(M, 0);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  for (int it = tid; it < G::FT * S; it += G::NT) {
    const int f = it / S, i = it - f * S;
    const float* fr = seg + f * hop;
    const bool pairs = (reinterpret_cast<std::uintptr_t>(fr) & 7) == 0;
    float2 v[mapt::kRegPoints];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = i + r * S;
      const float2 w = __ldg(win2 + m);
      const float2 x = pairs ? reinterpret_cast<const float2*>(fr)[m]
                             : make_float2(fr[2 * m], fr[2 * m + 1]);
      v[r] = make_float2(w.x * x.x, w.y * x.y);
    }
    mapt::mixed_dft<R, 0>(v);
    mapt::mixed_twiddle<M, 0>(v, twp, i);
#pragma unroll
    for (int r = 0; r < R; ++r) buf[f * G::FS + i + r * S] = v[r];
  }
}

// Passes PASS.. in place, frames fastest across lanes, each ended by a
// barrier
template <int N, int PASS>
__device__ __forceinline__ void mixed_later_passes(float2* buf, const float2* twp, int tid) {
  using G = MixedGeometry<N>;
  constexpr int M = G::M;
  if constexpr (PASS < G::P) {
    constexpr int R = mapt::mixed_radix(M, PASS), S = mapt::mixed_stride(M, PASS);
    for (int it = tid; it < G::FT * (M / R); it += G::NT) {
      const int f = it % G::FT, u = it / G::FT;
      const int blk = u / S, i = u - blk * S;
      float2* p = buf + f * G::FS + blk * R * S + i;
      float2 v[mapt::kRegPoints];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = p[r * S];
      mapt::mixed_dft<R, 0>(v);
      mapt::mixed_twiddle<M, PASS>(v, twp, i);
#pragma unroll
      for (int r = 0; r < R; ++r) p[r * S] = v[r];
    }
    __syncthreads();
    mixed_later_passes<N, PASS + 1>(buf, twp, tid);
  }
}

// Bin k of frame f as bf16 hi and lo halves in the rows (word k / 2 of the
// frame, the even bin in the low half); whether hi is not finite
template <int RS>
__device__ __forceinline__ bool put_bin(unsigned short* hi16, unsigned short* lo16, int k, int f,
                                        float p) {
  const __nv_bfloat16 h = __float2bfloat16_rn(p);
  const unsigned short hb = __bfloat16_as_ushort(h);
  const int at = 2 * ((k >> 1) * RS + f) + (k & 1);
  hi16[at] = hb;
  lo16[at] = __bfloat16_as_ushort(__float2bfloat16_rn(p - __bfloat162float(h)));
  return (hb & 0x7F80u) == 0x7F80u;
}

// The power rows of the tile, frames fastest across lanes: for k = 0..M/2,
// X[k] and X[M-k] from Z[k] and Z[M-k] (Z[0] for k = 0) at their positions
// after the passes; a warp that wrote a value that is not finite sets the
// tile's flag
template <int N>
__device__ __forceinline__ void mixed_power_rows(const float2* buf, const int* pos,
                                                 const float2* __restrict__ tw_g,
                                                 unsigned* rows_hi, unsigned* rows_lo, int* flag,
                                                 bool mag, int tid) {
  using G = MixedGeometry<N>;
  constexpr int M = G::M;
  unsigned short* hi16 = reinterpret_cast<unsigned short*>(rows_hi);
  unsigned short* lo16 = reinterpret_cast<unsigned short*>(rows_lo);
  bool bad = false;
  // FT * (M/2 + 1) items: every lane of a warp takes the same number
  for (int it = tid; it < G::FT * (M / 2 + 1); it += G::NT) {
    const int f = it % G::FT, k = it / G::FT;
    const float2* z = buf + f * G::FS;
    const float2 a = z[pos[k]], c = z[pos[k == 0 ? 0 : M - k]];
    const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
    const float dr = 0.5f * (a.x - c.x), di = 0.5f * (a.y + c.y);
    const float2 o = mapt::cmul(__ldg(tw_g + k), make_float2(di, -dr));
    const float xr = er + o.x, xi = ei + o.y;  // X[k]
    const float yr = er - o.x, yi = o.y - ei;  // X[M-k]
    const float pk = xr * xr + xi * xi, pmk = yr * yr + yi * yi;
    bad |= put_bin<G::RS>(hi16, lo16, k, f, mag ? sqrtf(pk) : pk);
    if (2 * k != M) bad |= put_bin<G::RS>(hi16, lo16, M - k, f, mag ? sqrtf(pmk) : pmk);
  }
  if (__any_sync(0xffffffffu, bad) && (tid & 31) == 0) *flag = 1;
}

// The contraction of the tile's rows with W: warp -> (m-tile, n-tile)
// units; an m-tile's k-steps are its band in the plan, or all of them
// (full); c0, c1 of a unit are column ca, frames 8j + 2q, +1; c2, c3 column
// ca + 8
template <int N>
__device__ __forceinline__ void mixed_contract(const unsigned* rows_hi, const unsigned* rows_lo,
                                               const int* __restrict__ plan, bool full,
                                               float* __restrict__ out, int b, int f0, int F,
                                               int n_cols, int n_mt, int tid) {
  using G = MixedGeometry<N>;
  constexpr int KSTEPS = G::KSTEPS, RS = G::RS, NTILE = G::FT / 8;
  constexpr int NEXT_COL = 8 * KSTEPS * 4;  // uint4s from column ca to ca + 8
  const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const uint4* wplan = reinterpret_cast<const uint4*>(plan + mapt::plan_w_offset(n_mt));
  for (int u = warp; u < n_mt * NTILE; u += G::NW) {
    const int mt = u / NTILE, j = u - mt * NTILE;
    int kb = 0, ke = KSTEPS;
    if (!full) {
      kb = __ldg(plan + mapt::kPlanHeader + n_mt + 1 + mt);
      ke = kb + __ldg(plan + mapt::kPlanHeader + mt + 1) - __ldg(plan + mapt::kPlanHeader + mt);
    }
    const int ca = 16 * mt + g, f = 8 * j + g;
    const uint4* w = wplan + static_cast<size_t>(ca) * KSTEPS * 4 + q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = kb; kk < ke; ++kk) {
      const uint4 a0 = __ldg(w + 4 * kk), a1 = __ldg(w + 4 * kk + NEXT_COL);
      const unsigned ahi[4] = {a0.x, a1.x, a0.y, a1.y};
      const unsigned alo[4] = {a0.z, a1.z, a0.w, a1.w};
      const int wd = (8 * kk + 2 * q) * RS + f;
      const unsigned bhi[2] = {rows_hi[wd], rows_hi[wd + RS]};
      const unsigned blo[2] = {rows_lo[wd], rows_lo[wd + RS]};
      // from zero each k-step, as K1's fast entry
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mapt::mma_bf16(d, alo, bhi);
      mapt::mma_bf16(d, ahi, blo);
      mapt::mma_bf16(d, ahi, bhi);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += d[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int fl = 8 * j + 2 * q + (i & 1), col = ca + 8 * (i >> 1);
      if (f0 + fl < F && col < n_cols)
        out[(static_cast<long long>(b) * n_cols + col) * F + f0 + fl] = acc[i];
    }
  }
}

// A persistent grid over (clip, tile of 32 frames) pairs
template <int N>
__global__ void __launch_bounds__(MixedGeometry<N>::NT, 2)
mel_fused_mixed_kernel(const float* __restrict__ y, long long L, const float* __restrict__ win,
                       const float2* __restrict__ tw_g, const int* __restrict__ plan,
                       float* __restrict__ out, int hop, int F, int n_cols, int n_mt, int pad,
                       int mode, int power, int tiles, int total) {
  using G = MixedGeometry<N>;
  constexpr int M = G::M, FT = G::FT, NT = G::NT;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float2* buf = reinterpret_cast<float2*>(base);
  unsigned* rows_hi = reinterpret_cast<unsigned*>(base + G::ROWS_OFF);
  unsigned* rows_lo = rows_hi + G::WORDS * G::RS;
  float2* twp = reinterpret_cast<float2*>(base + G::TW_OFF);
  int* pos = reinterpret_cast<int*>(base + G::POS_OFF);
  int* flag = reinterpret_cast<int*>(base + G::FLAG_OFF);
  float* seg = reinterpret_cast<float*>(base + G::SEG_OFF);
  const int tid = threadIdx.x;
  const int seg_len = (FT - 1) * hop + N;

  mapt::stage_mixed_twiddles<M>(twp, tw_g, tid, NT);
  for (int k = tid; k < M; k += NT) pos[k] = mapt::mixed_pos(M, k);
  for (int w = tid; w < 2 * G::WORDS * G::RS; w += NT) rows_hi[w] = 0u;
  int tile = blockIdx.x;
  int off = mapt::stage_segment(y + static_cast<long long>(tile / tiles) * L, L,
                                static_cast<long long>(tile % tiles) * FT * hop - pad, seg_len,
                                mode, seg, tid, NT);
  mapt::cp_async_wait_all();
  __syncthreads();

  for (; tile < total; tile += gridDim.x) {
    if (tid == 0) *flag = 0;  // the last tile's reads of it ended at its last barrier
    mixed_first_pass<N>(buf, seg + off, hop, win, twp, tid);
    __syncthreads();
    // the segment is free: copy the next tile's during the rest of this one
    const int next = tile + gridDim.x;
    if (next < total)
      off = mapt::stage_segment(y + static_cast<long long>(next / tiles) * L, L,
                                static_cast<long long>(next % tiles) * FT * hop - pad, seg_len,
                                mode, seg, tid, NT);
    mixed_later_passes<N, 1>(buf, twp, tid);
    mixed_power_rows<N>(buf, pos, tw_g, rows_hi, rows_lo, flag, power == 1, tid);
    __syncthreads();
    mixed_contract<N>(rows_hi, rows_lo, plan, *flag != 0, out, tile / tiles,
                      (tile % tiles) * FT, F, n_cols, n_mt, tid);
    mapt::cp_async_wait_all();
    __syncthreads();
  }
}

// The instances: n_fft 400 (kernels/mel_fused.py::MIXED_N_FFTS)
#define MAPT_K1M_NS(X) X(400)

template <int N>
cudaError_t open_mixed(int device) {
  static bool opened[kMaxDevices];
  if (opened[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      mel_fused_mixed_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, mapt::kSmemLimit);
  opened[device] = err == cudaSuccess;
  return err;
}

template <int N>
int mixed_launch_n(const float* y, long long L, const float* win, const float* tw, const int* plan,
                   float* out, int B, int hop, int F, int n_cols, int pad, int mode, int power,
                   int device, cudaStream_t stream) {
  using G = MixedGeometry<N>;
  const size_t smem = G::smem(hop);
  if (smem > mapt::kSmemLimit || hop < 1 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the grid: SMs times resident blocks, found once per device and hop's
  // shared memory
  static size_t sized[kMaxDevices];
  static int slots[kMaxDevices];
  if (sized[device] != smem) {
    int per_sm = 0, sms = 0;
    cudaError_t err = open_mixed<N>(device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_fused_mixed_kernel<N>, G::NT,
                                                          smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[device] = sms * per_sm;
    sized[device] = smem;
  }
  const int tiles = (F + G::FT - 1) / G::FT;
  const long long all = static_cast<long long>(B) * tiles;
  if (all <= 0) return static_cast<int>(cudaSuccess);
  if (all > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(all < slots[device] ? all : slots[device]);
  mel_fused_mixed_kernel<N><<<grid, G::NT, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), plan, out, hop, F, n_cols,
      (n_cols + 15) / 16, pad, mode, power, tiles, static_cast<int>(all));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, n_cols, F) = |rDFT(win * frame)|^power @ W, W from the plan of
// ceil(n_cols / 16) m-tiles and ceil((n_fft/2 + 1) / 16) k-steps
extern "C" int mel_fused_mixed_launch(const float* y, long long L, const float* win,
                                      const float* tw, const int* plan, float* out, int B,
                                      int n_fft, int hop, int F, int n_cols, int pad, int mode,
                                      int power, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
#define MAPT_CASE(N) \
  case N: return mixed_launch_n<N>(y, L, win, tw, plan, out, B, hop, F, n_cols, pad, mode, power, device, s);
    MAPT_K1M_NS(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
