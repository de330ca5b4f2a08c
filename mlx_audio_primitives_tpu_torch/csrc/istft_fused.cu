// K3: fused ISTFT, spectrum -> windowed, overlap-added, normalized signal.
//
// Replaces mlx_audio_primitives_tpu/kernels/istft_fused.py::istft_pallas
// (pallas_call in _istft_grouped_core); its transposed and natural intakes
// (istft_pallas_t, istft_pallas_nat) compute the same function and are
// served by this kernel's strided intake: the spectrum is read through any
// strides, so both (B, F, n_bins) and the natural (B, n_bins, F) layout are
// read in place. The imaginary parts of the DC and Nyquist bins are dropped
// (irfft semantics).
//
// What bounds it on this card: one read of the spectrum (8 bytes per bin
// per frame) and one write of the output, against ~5 GFLOP of FFT at
// 64 x 30 s clips, so bytes; the FFT has to stay out of their way. The
// design:
//
// - the inverse real FFT is the forward register-resident FFT of
//   fft_common.cuh (K2's passes, per-pass twiddles in shared memory,
//   barriers per group of threads that own a frame, K2's tile of FT frames)
//   run on Y = conj(Z) / M (irfft_pack): IFFT_M(Z) = conj(FFT_M(conj Z)) / M.
//   Pass 0 takes its points straight from the spectrum into registers. A
//   thread owns the butterflies u and S0 - u of pass 0, whose points are
//   each other's partners k and M - k, so it reads each bin once (where
//   pass 0 has radix 16, the partner butterfly is another thread's and both
//   read the pair). Threads are frames fastest in pass 0, so on the natural
//   layout a warp reads FT consecutive frames of a bin: at n_fft 2048 16
//   frames, one whole 128-byte line;
// - a block walks a span of output hop-rows of one or more clips in tiles
//   of FT frames; a tile completes the FT rows that start at its frames,
//   and the C - 1 rows after them, which its last frames reach, carry their
//   partial sums in shared memory to the next tile. Only the first tile of
//   a span recomputes frames: the C - 1 before the span's first row. The
//   launcher sizes the span from the batch: one tile per block while the
//   grid has room, and at most one span per resident block beyond;
// - the overlap-add reads the transforms where the passes left them, in
//   digit-reversed order (rdigit_rev in the read index): thread (i, t) adds
//   into hop-row i of the tile, for its sample pairs, the C frames that
//   cover it, each read once, and sends each frame's term to the row's sum
//   or to a carried row without a branch. Lanes are rows fastest (8 rows by
//   4 pairs at n_fft 2048, IGeometry::RL), so the reads of a half-warp fall
//   on different frames (an odd frame stride) and bank pairs; the window is
//   staged in shared memory where it fits; it divides by the envelope and
//   stores.
//
// The spectrum's loads stay exposed: prefetching the next tile into
// registers spills at 64 registers, and into a second set of frame buffers
// leaves room for one block of 512 threads an SM; both measured slower
// (PERF.md). tests/test_torch_port_istft_plan.py models these maps in
// NumPy.
#include <cstdint>

#include "fft_common.cuh"

namespace {

constexpr int kMaxDevices = 64;

// K2's tile (mapt::Geometry: FT frames of T = M/16 threads, at most 1024
// threads, 512 from n_fft 4096 on) and, at C = n_fft / hop, the overlap-add's
template <int LOG_M, int C>
struct IGeometry : mapt::Geometry<LOG_M> {
  using Base = mapt::Geometry<LOG_M>;
  using Base::FS;
  using Base::FT;
  using Base::M;
  using Base::T;
  static constexpr int H = M / C;  // sample pairs per hop-row
  // rows a thread adds into per tile: its own and those carried on
  static constexpr int K = 1 + (C - 1 + FT - 1) / FT;
  static constexpr int CS = H + 1;  // carried row stride (float2)
  static constexpr int R0 = 1 << mapt::plan_bits(LOG_M, 0);  // pass 0's radix
  static constexpr int S0 = M / R0;  // and its butterflies
  // The overlap-add's lanes: RL rows (frames) by 32 / RL consecutive sample
  // pairs. 8 rows where a pair's neighbour lies 8 bank pairs away in the
  // digit-reversed frame (n_fft 128 and 2048): a half-warp's reads then
  // fall on 16 bank pairs and a warp stores 32 bytes a row; else FT rows
  static constexpr int NEAR = mapt::rdigit_rev(LOG_M, 1);  // where pair 1 sits
  static constexpr int RL = FT >= 8 && (NEAR + (NEAR >> 4)) % 16 == 8 ? 8 : FT;
  static constexpr int LOG_RL = RL == 16 ? 4 : RL == 8 ? 3 : RL == 4 ? 2 : RL == 2 ? 1 : 0;
  // float2 offsets: frame buffers, the passes' twiddle tables (room for M
  // entries), the C - 1 carried rows, and the window where it fits (else it
  // is read from device memory)
  static constexpr int TW_OFF = FT * FS;
  static constexpr int CARRY_OFF = TW_OFF + M;
  static constexpr int WIN_OFF = CARRY_OFF + (C - 1) * CS;
  static constexpr bool WIN_STAGED = sizeof(float2) * (WIN_OFF + M) <= mapt::kSmemLimit;
  static constexpr size_t SMEM = sizeof(float2) * static_cast<size_t>(WIN_OFF + (WIN_STAGED ? M : 0));
  static_assert(R0 == 8 || R0 == 16, "pass 0 has radix 8 or 16");
  static_assert(R0 == 16 || S0 == 2 * T, "two radix-8 butterflies a thread");
};

// The bins pass 0 of one frame needs from thread t. R0 = 8: thread t owns
// butterflies u0 = t and u1 = S0 - t, whose points k = t + r*S0 and M - k
// pair up (point r of u0 with point 7 - r of u1), so it loads 16 bins for
// 16 points: a[r] = X[k], b[r] = X[M - k]; thread 0 owns u0 = 0 and
// u1 = T, each its own partner: a[r] = X[r*S0], b[r] = X[T + r*S0] and
// xm = X[M]. R0 = 16: thread t owns u0 = t and loads its 16 bins and their
// 16 partners (X[M] for t = 0 in b[0]), which thread S0 - t loads too.
template <int LOG_M, int C>
struct Bins {
  static constexpr int R0 = IGeometry<LOG_M, C>::R0;
  float2 a[R0], b[R0], xm;
};

template <int LOG_M, int C>
__device__ __forceinline__ int bin_b(int t, int r) {
  using G = IGeometry<LOG_M, C>;
  return G::R0 == 16 || t != 0 ? G::M - t - r * G::S0 : G::T + r * G::S0;
}

// Sf: the frame's bins X[k] at Sf[k * sk], or nullptr for a frame that adds
// nothing (zeros). Read once, so cached in L2 only (ld.global.cg).
template <int LOG_M, int C>
__device__ __forceinline__ void load_bins(Bins<LOG_M, C>& x, const float2* __restrict__ Sf,
                                          long long sk, int t) {
  using G = IGeometry<LOG_M, C>;
  if (Sf == nullptr) {
#pragma unroll
    for (int r = 0; r < G::R0; ++r) x.a[r] = x.b[r] = make_float2(0.f, 0.f);
    x.xm = make_float2(0.f, 0.f);
    return;
  }
#pragma unroll
  for (int r = 0; r < G::R0; ++r) {
    x.a[r] = __ldcg(Sf + (t + r * G::S0) * sk);
    x.b[r] = __ldcg(Sf + bin_b<LOG_M, C>(t, r) * sk);
  }
  if (G::R0 == 8 && t == 0) x.xm = __ldcg(Sf + G::M * sk);
}

// Pass 0 of one frame from its bins (load_bins): the Y points (irfft_pack)
// into registers, the radix-R0 butterflies and their twiddles, the stores
// into the frame buffer fb. The pack's twiddles W_N^{t + r*S0} are
// W_N^t W_16^r (S0 = N/16 where R0 = 8): one load a thread.
template <int LOG_M, int C>
__device__ __forceinline__ void inverse_first_pass(float2 (&v)[mapt::kRegPoints],
                                                   Bins<LOG_M, C>& x,
                                                   const float2* __restrict__ tw_g,
                                                   const float2* twp, float2* fb, int t) {
  using G = IGeometry<LOG_M, C>;
  constexpr int M = G::M, R0 = G::R0, S0 = G::S0, B0 = mapt::plan_bits(LOG_M, 0);
  constexpr float kScale = 0.5f / M;
  const float2* tw0 = twp + mapt::rtw_offset(LOG_M, 0);
  float2 dummy;
  if constexpr (R0 == 8) {
    const int u1 = t ? S0 - t : G::T;
    if (t != 0) {
      const float2 wt = __ldg(tw_g + t);
#pragma unroll
      for (int r = 0; r < R0; ++r)
        mapt::irfft_pack(x.a[r], x.b[r], r ? mapt::cmul(wt, mapt::w16(r)) : wt, kScale, v[r],
                         v[2 * R0 - 1 - r]);
    } else {
      x.a[0].y = 0.f;  // X[0] and X[M] are real
      x.xm.y = 0.f;
      const float2 wT = __ldg(tw_g + G::T);
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        mapt::irfft_pack(x.a[r], r ? x.a[R0 - r] : x.xm, mapt::w16(r), kScale, v[r], dummy);
        mapt::irfft_pack(x.b[r], x.b[R0 - 1 - r], r ? mapt::cmul(wT, mapt::w16(r)) : wT, kScale,
                         v[R0 + r], dummy);
      }
    }
    mapt::dft_regs<B0, 0>(v);
    mapt::rtwiddle<S0, 0, 1, R0>(v, tw0, t);
    mapt::store_butterfly<S0, R0, 0>(v, fb, t);
    mapt::dft_regs<B0, R0>(v);
    mapt::rtwiddle<S0, R0, 1, R0>(v, tw0, u1);
    mapt::store_butterfly<S0, R0, R0>(v, fb, u1);
  } else {
    if (t == 0) x.a[0].y = x.b[0].y = 0.f;
#pragma unroll
    for (int r = 0; r < R0; ++r)
      mapt::irfft_pack(x.a[r], x.b[r], __ldg(tw_g + t + r * S0), kScale, v[r], dummy);
    mapt::dft_regs<B0, 0>(v);
    mapt::rtwiddle<S0, 0, 1, R0>(v, tw0, t);
    mapt::store_butterfly<S0, R0, 0>(v, fb, t);
  }
}

// The overlap-add of one tile, frames g .. g+FT-1 transformed in buf:
// thread (row i, t) adds into hop-row g+i, for its sample pairs
// p = t + n*T, the terms of frames i-c (c = 0..C-1) that lie in the tile;
// the term of slot j = (i-c) mod FT of a frame before the tile belongs to
// row g+i+FT*k (k = (j+c-i)/FT >= 1), a row past the tile, whose partial
// sum is carried to the next tile in slot i + FT*(k-1) < C-1. A thread owns
// the carried slots of its row modulo FT, so reading and writing them needs
// no barrier. Point c*H + p of a frame sits at
// rpidx(rdigit_rev(c*H)) + rpidx(rdigit_rev(p)) (the two share no bit); the
// frame's samples 2m, 2m+1 are (Re, -Im) of point m (z = conj(FFT(Y))).
// Row g+i is written where it lies in [r0, r1): the sum divided by the
// envelope (1.0 past its length), samples past T dropped.
template <int LOG_M, int C>
__device__ __forceinline__ void overlap_add_tile(const float2* buf, float2* carry,
                                                 const float2* win2,
                                                 const float* __restrict__ env, long long env_len,
                                                 bool env_pairs, float* ob, bool pairs_ok,
                                                 long long T, int g, int r0, int r1, bool first,
                                                 int i, int t) {
  using G = IGeometry<LOG_M, C>;
  constexpr int FT = G::FT, H = G::H, K = G::K;
  const int row = g + i;
  const bool keep = row >= r0 && row < r1;
  // one pair at a time: unrolled, the pairs' loads would be hoisted
  // together and spill
#pragma unroll 1
  for (int n = 0; n < 16 / C; ++n) {
    const int p = t + n * G::T;
    const int pos = mapt::rpidx(mapt::rdigit_rev(LOG_M, p));
    float2 acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = i + FT * k;
      acc[k] = (!first && q < C - 1) ? carry[q * G::CS + p] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = (i - c) & (FT - 1);
      const int kc = (j + c - i) >> G::LOG_FT;
      const float2 z = buf[j * G::FS + pos + mapt::rpidx(mapt::rdigit_rev(LOG_M, c * H))];
      const float2 w = win2[c * H + p];
      const float x0 = w.x * z.x, x1 = -w.y * z.y;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == kc) {
          acc[k].x += x0;
          acc[k].y += x1;
        }
      }
    }
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const int q = i + FT * (k - 1);
      if (q < C - 1) carry[q * G::CS + p] = acc[k];
    }
    const long long s = static_cast<long long>(row) * (2 * H) + 2 * p;  // the pair's first sample
    if (keep && s < T) {
      float2 e;
      if (env_pairs && s + 1 < env_len) {
        e = __ldg(reinterpret_cast<const float2*>(env + s));
      } else {
        e.x = s < env_len ? __ldg(env + s) : 1.f;
        e.y = s + 1 < env_len ? __ldg(env + s + 1) : 1.f;
      }
      if (pairs_ok && s + 1 < T) {
        *reinterpret_cast<float2*>(ob + s) = make_float2(acc[0].x / e.x, acc[0].y / e.y);
      } else {
        ob[s] = acc[0].x / e.x;
        if (s + 1 < T) ob[s + 1] = acc[0].y / e.y;
      }
    }
  }
}

// The thread index as a value the compiler cannot see through: each phase
// of a tile derives its own indices from it instead of keeping them live
// through the other phases, where they would spill
__device__ __forceinline__ int opaque(int v) {
  int r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// The tiles of one block, in order: block bi takes the global hop-rows
// [bi*span, (bi+1)*span) of the B clips' `rows` rows each, clip after clip;
// each run of them within one clip is a segment [r0, r1), walked in tiles
// of FT frames from frame r0 - (C-1) (the frames whose windows reach row
// r0; 0 at a clip's start). next() moves to the following tile and returns
// false past the block's last.
struct TileWalk {
  long long cur, end;
  int rows, C, FT;
  int b = 0, r0 = 0, r1 = 0, g = 0;
  bool first = true;

  __device__ bool next() {
    if (r1 > 0 && g + FT < r1) {
      g += FT;
      first = false;
      return true;
    }
    if (cur >= end) return false;
    b = static_cast<int>(cur / rows);
    r0 = static_cast<int>(cur - static_cast<long long>(b) * rows);
    r1 = static_cast<int>(min(static_cast<long long>(rows), r0 + (end - cur)));
    cur += r1 - r0;
    g = r0 > C - 1 ? r0 - (C - 1) : 0;
    first = true;
    return true;
  }
};

// Per tile: the bins into registers and pass 0, the later passes, the
// overlap-add; frames at or past min(F, r1) add nothing to the segment's
// rows and are not read. Up to n_fft 4096, 64 registers a thread (1024
// threads an SM); where pass 0 has radix 16 it holds 32 bins at once,
// which needs more.
template <int LOG_M, int C>
__global__ void __launch_bounds__(IGeometry<LOG_M, C>::NT,
                                  IGeometry<LOG_M, C>::R0 == 16 ? 1 : 1024 / IGeometry<LOG_M, C>::NT)
istft_kernel(const float2* __restrict__ S, long long sb, long long sf, long long sk,
             const float* __restrict__ win, const float2* __restrict__ tw_g,
             const float* __restrict__ env, long long env_len, float* __restrict__ out,
             int F, long long T, int rows, long long rows_total, long long span) {
  using G = IGeometry<LOG_M, C>;
  constexpr int FT = G::FT;
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float2* twp = buf + G::TW_OFF;
  const float2* win2 = reinterpret_cast<const float2*>(win);
  mapt::stage_twiddles<LOG_M>(twp, tw_g, threadIdx.x, G::NT);
  if constexpr (G::WIN_STAGED) {
    for (int x = threadIdx.x; x < G::M; x += G::NT) buf[G::WIN_OFF + x] = __ldg(win2 + x);
    win2 = buf + G::WIN_OFF;
  }
  __syncthreads();  // the twiddles and the window are staged
  const bool env_pairs = (reinterpret_cast<size_t>(env) & 7) == 0;  // float2 loads of env

  TileWalk walk{static_cast<long long>(blockIdx.x) * span, 0, rows, C, FT};
  walk.end = min(rows_total, walk.cur + span);
  while (walk.next()) {
    float2 v[mapt::kRegPoints];
    {
      // pass 0: frame slot i, thread t, frames fastest
      const int me = opaque(threadIdx.x), i = me & (FT - 1), t = me >> G::LOG_FT;
      const int f = walk.g + i;
      Bins<LOG_M, C> x;
      load_bins<LOG_M, C>(x, f < min(F, walk.r1) ? S + walk.b * sb + f * sf : nullptr, sk, t);
      inverse_first_pass<LOG_M, C>(v, x, tw_g, twp, buf + i * G::FS, t);
    }
    __syncthreads();  // pass 0 wrote each frame from every warp
    {
      // the later passes: K2's map, T threads a frame
      const int me = opaque(threadIdx.x);
      mapt::rexchange_passes<LOG_M, 1, G::GT>(buf + (me / G::T) * G::FS, v, twp, me % G::T,
                                             G::GT ? me / G::GT : 0);
    }
    __syncthreads();
    {
      // the overlap-add: hop-row i, sample pairs t + n*T; a warp holds RL
      // rows of 32 / RL pairs (lanes), its warps the other rows and pairs
      const int me = opaque(threadIdx.x), lane = me & 31, warp = me >> 5;
      constexpr int WR = FT / G::RL;  // warps across the rows
      const int i = (lane & (G::RL - 1)) + G::RL * (warp & (WR - 1));
      const int t = (lane >> G::LOG_RL) + (32 >> G::LOG_RL) * (warp / WR);
      overlap_add_tile<LOG_M, C>(buf, buf + G::CARRY_OFF, win2, env, env_len, env_pairs,
                                 out + walk.b * T, ((walk.b * T) & 1) == 0, T, walk.g, walk.r0,
                                 walk.r1, walk.first, i, t);
    }
    __syncthreads();  // the frame buffers are free for the next pass 0
  }
}

// Per device and instance: resident blocks per SM and the SM count,
// queried once
template <int LOG_M, int C>
cudaError_t occupancy_of(int device, int* per_sm, int* sms) {
  using G = IGeometry<LOG_M, C>;
  static int cached[kMaxDevices][2];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (!cached[device][0]) {
    cudaError_t err = cudaFuncSetAttribute(istft_kernel<LOG_M, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(G::SMEM));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[device][1],
                                                          istft_kernel<LOG_M, C>, G::NT, G::SMEM);
    if (err == cudaSuccess && cached[device][1] < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached[device][0], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) {
      cached[device][0] = 0;
      return err;
    }
  }
  *sms = cached[device][0];
  *per_sm = cached[device][1];
  return cudaSuccess;
}

// The launch plan: info = {threads per block, frames per tile, dynamic
// shared memory per block, resident blocks per SM, grid, span (hop-rows a
// block)}. The span is one tile's new rows (FT - (C-1), at least 1) while
// the grid has room for every block, else the rows spread evenly over
// every resident block.
template <int LOG_M, int C>
cudaError_t plan_of(long long rows_total, int device, long long* info) {
  using G = IGeometry<LOG_M, C>;
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy_of<LOG_M, C>(device, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const long long least = G::FT - (C - 1) > 1 ? G::FT - (C - 1) : 1;
  const long long even = (rows_total + slots - 1) / slots;
  const long long span = even > least ? even : least;
  info[0] = G::NT;
  info[1] = G::FT;
  info[2] = static_cast<long long>(G::SMEM);
  info[3] = per_sm;
  info[4] = (rows_total + span - 1) / span;
  info[5] = span;
  return cudaSuccess;
}

template <int LOG_M, int C>
int launch_mc(const float2* S, long long sb, long long sf, long long sk, const float* win,
              const float2* tw, const float* env, long long env_len, float* out, int B, int F,
              long long T, int device, cudaStream_t stream) {
  using G = IGeometry<LOG_M, C>;
  const long long rows = (T + 2 * G::H - 1) / (2 * G::H);
  const long long rows_total = static_cast<long long>(B) * rows;
  if (rows_total <= 0) return static_cast<int>(cudaSuccess);
  if (rows > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  long long info[6];
  cudaError_t err = plan_of<LOG_M, C>(rows_total, device, info);
  if (err != cudaSuccess) return static_cast<int>(err);
  istft_kernel<LOG_M, C><<<static_cast<unsigned>(info[4]), G::NT, G::SMEM, stream>>>(
      S, sb, sf, sk, win, tw, env, env_len, out, F, T, static_cast<int>(rows), rows_total, info[5]);
  return static_cast<int>(cudaGetLastError());
}

// The instances: n_fft = 2^(LOG_M+1) and C = n_fft / hop for every shape
// the radix gate admits (hop = 128 .. 1024, C <= 8)
#define MAPT_K3_SHAPES(X)                                                       \
  X(6, 1) X(7, 1) X(7, 2) X(8, 1) X(8, 2) X(8, 4) X(9, 1) X(9, 2) X(9, 4) X(9, 8) \
  X(10, 2) X(10, 4) X(10, 8) X(11, 4) X(11, 8) X(12, 8)

constexpr int shape_key(int log_m, int c) { return 16 * log_m + c; }

}  // namespace

extern "C" int istft_launch(const float* S, long long sb, long long sf, long long sk,
                            const float* win, const float* tw, const float* env,
                            long long env_len, float* out, int B, int n_fft,
                            int hop, int F, long long T, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto S2 = reinterpret_cast<const float2*>(S);
  const auto tw2 = reinterpret_cast<const float2*>(tw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (shape_key(__builtin_ctz(static_cast<unsigned>(n_fft / 2)), n_fft / hop)) {
#define MAPT_CASE(L, C)                                                                  \
  case shape_key(L, C):                                                                  \
    return launch_mc<L, C>(S2, sb, sf, sk, win, tw2, env, env_len, out, B, F, T, device, s);
    MAPT_K3_SHAPES(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan of a launch of B clips of T samples (plan_of); the wrapper
// reads it for the recompute share
extern "C" int istft_plan(int n_fft, int hop, int B, long long T, int device, long long* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_total = static_cast<long long>(B) * ((T + hop - 1) / hop);
  switch (shape_key(__builtin_ctz(static_cast<unsigned>(n_fft / 2)), n_fft / hop)) {
#define MAPT_CASE(L, C) \
  case shape_key(L, C): return static_cast<int>(plan_of<L, C>(rows_total, device, info));
    MAPT_K3_SHAPES(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
