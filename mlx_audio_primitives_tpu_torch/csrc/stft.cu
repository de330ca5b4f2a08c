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
//
// K2s (stft_stats_kernel) is the third emit: one per-frame statistic of
// the magnitude, chosen at launch (spectral bandwidth, rolloff or
// flatness; one instance each), so that the magnitude never reaches device
// memory. It replaces no TPU kernel: the JAX package computes these
// features with XLA on a magnitude spectrogram (ops/features.py). In the
// port that was the magnitude emit (K2m) and then some 30 PyTorch passes
// over its output for the three features, each a reduction over one
// frame's bins. What bounds it: y read once and 4 bytes a frame written (at
// 64 x 30 s ~170 MB, 0.05 ms at 3.35 TB/s), against the same ~5 GFLOP of
// FFT as K2m, so it is bound by the FFT front end, which it shares
// unchanged with K2 and K2m (the same tile, front end and persistent grid).
// The reduction's layout:
//
// - the emit's lanes (frames fastest) form the magnitudes of their bins k
//   and M - k as K2m does. Each Z slot of the frame buffer is read by one
//   lane only, so a lane may keep a magnitude in the slot it has just read
//   (a float of Z[k]'s slot, stash_of; X[M] in the .y of Z[0]'s) without a
//   barrier and without holding it in registers;
// - bandwidth and flatness sum as the lanes go: xor shuffles among a warp's
//   lanes of a frame, one of the frame buffer's free padding slots a warp,
//   a block barrier, and xor shuffles over a frame's warp sums, one lane
//   each (emit_sums). Bandwidth makes two such passes: the centroid's two
//   sums, then, from the kept magnitudes, the deviations'. Flatness makes
//   one (the sums of log2 x and of x);
// - rolloff needs its running sum in bin order: after a block barrier the
//   frame's own T threads (as in the passes) read bins 16t .. 16t + 15 in
//   order from the kept magnitudes (thread T - 1 also bin M), scan their
//   sums across the frame (shuffles, then the warps' totals through
//   padding slots behind the passes' group barriers), and take the first
//   bin at or past the threshold;
// - one thread a frame writes the frame's result.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// K2s: the per-frame statistics emit (see the note at the top)

enum Stat : int { kBandwidth = 0, kRolloff = 1, kFlatness = 2 };

// Free float2 slots of a frame buffer (frame buffer layout): rpidx leaves
// slot 17j + 16 unused for j < M/16 (the padding), and the buffer's last
// slot, FS - 1
__device__ __forceinline__ float2* pad_slot(float2* fz, int j) { return fz + 17 * j + 16; }

// Where the thread's pair of bins k = k0 + J*T, M - k read from in frame z
// (emit_pairs' read index): Z[k]'s slot pa, Z[M-k]'s slot pc (pa at k = 0
// and at k = M/2)
template <int LOG_M, int J>
__device__ __forceinline__ void pair_slots(float2* z, int k0, int lo1, int lo2, float2*& pa,
                                           float2*& pc) {
  constexpr int M = 1 << LOG_M, T = M >> mapt::kRegBits;
  constexpr int h1 = mapt::rdigit_rev(LOG_M, J * T);
  constexpr int h2_0 = mapt::rdigit_rev(LOG_M, (M - J * T) & (M - 1));
  constexpr int h2 = mapt::rdigit_rev(LOG_M, (M - (J + 1) * T) & (M - 1));
  pa = z + mapt::rpidx(lo1 + h1);
  pc = z + mapt::rpidx(lo2 + (k0 ? h2 : h2_0));
}

// Where bin k < M's magnitude is kept: a float of Z[k]'s slot, the .y
// where bit 4 of k is set, else the .x (the rolloff's walk of bins 16t + i
// then reads at most two lanes a bank, four without it at n_fft 1024 and
// 2048). Bin M goes to the .y of Z[0]'s slot, whose .x holds bin 0.
__device__ __forceinline__ float* stash_of(float2* slot, int k) {
  return reinterpret_cast<float*>(slot) + ((k >> 4) & 1);
}

// emit_pairs' bins of frame z as magnitudes, with K2m's arithmetic:
// body(k, |X[k]|, stash) for each bin k the thread owns, where stash is a
// float of a slot that no other thread reads (the slot of Z[k] the thread
// has just read, stash_of), so the magnitude can be kept there without a
// barrier
template <int LOG_M, int J = 0, typename Body>
__device__ __forceinline__ void emit_mags(float2* z, const float2* __restrict__ tw_g, int k0,
                                          int lo1, int lo2, Body body) {
  constexpr int M = 1 << LOG_M, T = M >> mapt::kRegBits;
  if constexpr (J * T <= M / 2) {
    const int k = k0 + J * T;
    if (k <= M / 2) {
      float2 *pa, *pc;
      pair_slots<LOG_M, J>(z, k0, lo1, lo2, pa, pc);
      const float2 a = *pa, c = *pc;
      const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
      const float dr = 0.5f * (a.x - c.x), di = 0.5f * (a.y + c.y);
      const float2 o = mapt::cmul(__ldg(tw_g + k), make_float2(di, -dr));  // W_N^k O
      const float2 xk = make_float2(er + o.x, ei + o.y), xmk = make_float2(er - o.x, o.y - ei);
      body(k, sqrtf(xk.x * xk.x + xk.y * xk.y), stash_of(pa, k));
      if (k == 0)
        body(M, sqrtf(xmk.x * xmk.x + xmk.y * xmk.y), &pa->y);
      else if (k < M / 2)
        body(M - k, sqrtf(xmk.x * xmk.x + xmk.y * xmk.y), stash_of(pc, M - k));
    }
    emit_mags<LOG_M, J + 1>(z, tw_g, k0, lo1, lo2, body);
  }
}

// body(k, S[k]) for the thread's bins of frame z as emit_mags stashed them
template <int LOG_M, int J = 0, typename Body>
__device__ __forceinline__ void stashed_mags(float2* z, int k0, int lo1, int lo2, Body body) {
  constexpr int M = 1 << LOG_M, T = M >> mapt::kRegBits;
  if constexpr (J * T <= M / 2) {
    const int k = k0 + J * T;
    if (k <= M / 2) {
      float2 *pa, *pc;
      pair_slots<LOG_M, J>(z, k0, lo1, lo2, pa, pc);
      body(k, *stash_of(pa, k));
      if (k == 0)
        body(M, pa->y);
      else if (k < M / 2)
        body(M - k, *stash_of(pc, M - k));
    }
    stashed_mags<LOG_M, J + 1>(z, k0, lo1, lo2, body);
  }
}

// The sums of v over the T emit lanes of each frame (threads tid = f +
// FT*k0): xor shuffles among a warp's lanes of a frame, then one pad slot of
// the frame's buffer a warp, a block barrier, and thread f*NW + w reads
// warp w's sums of frame f (NW = NT/32 warps), which xor shuffles over
// the NW lanes combine. The sums of frame f are left in thread f*NW, for
// which this returns true.
template <int LOG_M, int N>
__device__ __forceinline__ bool emit_sums(float (&v)[N], float2* buf, int tid) {
  using G = mapt::Geometry<LOG_M>;
  constexpr int FT = G::FT, FS = G::FS, NW = G::NT / 32;
  static_assert(N <= 2 && NW <= G::M / 16 && FT * NW <= G::NT, "a pad slot a warp");
#pragma unroll
  for (int d = FT; d < 32; d <<= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], d);
  if ((tid & 31) < FT) {
    float2* slot = pad_slot(buf + (tid & (FT - 1)) * FS, tid >> 5);
    slot->x = v[0];
    if constexpr (N == 2) slot->y = v[1];
  }
  __syncthreads();
  const int f = tid / NW;
  float2 part = make_float2(0.f, 0.f);
  if (f < FT) part = *pad_slot(buf + f * FS, tid & (NW - 1));
  v[0] = part.x;
  if constexpr (N == 2) v[1] = part.y;
#pragma unroll
  for (int d = 1; d < NW; d <<= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], d);
  return f < FT && (tid & (NW - 1)) == 0;
}

// torch.pow(x, p) of a float tensor at p = 2 (x*x, as torch computes it)
// or 1
template <int P>
__device__ __forceinline__ float pow_k(float x) {
  static_assert(P == 1 || P == 2, "K2s takes the powers 1 and 2");
  return P == 2 ? x * x : x;
}

// flatness of each frame: 10^mean(log10 x) / (mean(x) + 1e-10) of
// x = max(S^P, amin), a NaN kept as torch.clamp keeps it; true in the
// thread that holds frame tid / NW's value (emit_sums). 10^mean(log10 x) =
// 2^mean(log2 x), and the logs are __log2f (MUFU.LG2: within 2^-22
// absolute on [0.5, 2], 2 ulp elsewhere) in place of log10f's ~30
// instructions a bin; a mean of 1,025 logs carries either rounding.
template <int LOG_M, int P>
__device__ __forceinline__ bool emit_flatness(float& r, float2* buf, int f, int tid,
                                              const float2* __restrict__ tw_g, int k0, int lo1,
                                              int lo2, float amin) {
  float v[2] = {0.f, 0.f};
  emit_mags<LOG_M>(buf + f * mapt::Geometry<LOG_M>::FS, tw_g, k0, lo1, lo2,
                   [&](int, float s, float*) {
                     float x = pow_k<P>(s);
                     x = x < amin ? amin : x;
                     v[0] += __log2f(x);
                     v[1] += x;
                   });
  const bool holds = emit_sums<LOG_M, 2>(v, buf, tid);
  constexpr float n = static_cast<float>((1 << LOG_M) + 1);
  r = exp2f(v[0] / n) / (v[1] / n + 1e-10f);
  return holds;
}

// bandwidth of each frame: the centroid c from a first pass (kept in the
// frame buffer's last slot for the frame's lanes), then (sum S |f - c|^P /
// (sum S + 1e-10 where norm))^(1/P) over the kept magnitudes; true in the
// thread that holds frame tid / NW's value (emit_sums)
template <int LOG_M, int P>
__device__ __forceinline__ bool emit_bandwidth(float& r, float2* buf, int f, int tid,
                                               const float2* __restrict__ tw_g,
                                               const float* __restrict__ freq, int k0, int lo1,
                                               int lo2, bool norm) {
  using G = mapt::Geometry<LOG_M>;
  float2* fz = buf + f * G::FS;
  float v[2] = {0.f, 0.f};
  emit_mags<LOG_M>(fz, tw_g, k0, lo1, lo2, [&](int k, float s, float* stash) {
    *stash = s;
    v[0] += s;
    v[1] += __ldg(freq + k) * s;
  });
  const bool holds = emit_sums<LOG_M, 2>(v, buf, tid);
  const float total = v[0];
  if (holds) buf[(tid / (G::NT / 32)) * G::FS + G::FS - 1].x = v[1] / (total + 1e-10f);
  __syncthreads();
  const float centroid = fz[G::FS - 1].x;
  float d[1] = {0.f};
  stashed_mags<LOG_M>(fz, k0, lo1, lo2, [&](int k, float s) {
    d[0] += s * pow_k<P>(fabsf(__ldg(freq + k) - centroid));
  });
  emit_sums<LOG_M, 1>(d, buf, tid);
  const float w = norm ? d[0] / (total + 1e-10f) : d[0];
  r = P == 2 ? sqrtf(w) : w;
  return holds;
}

// rolloff of the frame at fb from its T threads (fs, t), after emit_mags
// stashed its magnitudes and a barrier: thread t reads bins 16t .. 16t + 15
// in order (bin k's magnitude in Z[k]'s slot, stash_of; rdigit_rev(16t + i)
// = rdigit_rev(16t) + rdigit_rev(i)), thread T - 1 also bin M. The frequency
// of the first bin at which the running sum in bin order reaches
// roll_percent times the sum's own last value, so the last bin always
// reaches it; bin 0 where none does (a NaN threshold), as argmax of an
// all-False mask. In thread t = 0.
template <int LOG_M>
__device__ __forceinline__ float frame_rolloff(float2* fb, const float* __restrict__ freq, int tid,
                                               int t, float roll_percent) {
  using G = mapt::Geometry<LOG_M>;
  constexpr int M = G::M, T = G::T, P = mapt::kRegPoints, W = T < 32 ? T : 32;
  const int base = mapt::rdigit_rev(LOG_M, t * P);
  const bool last = t == T - 1;
  float s[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    s[i] = *stash_of(fb + mapt::rpidx(base + mapt::rdigit_rev(LOG_M, i)), t * P + i);
  const float sm = last ? fb[0].y : 0.f;
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) c += s[i];
  if (last) c += sm;

  // the sum of c over the frame's threads before t: a Hillis-Steele scan
  // of shuffles within the warp, then the totals of the frame's earlier
  // warps through pad slots (.x), behind the barrier of the group of frames
  // that the passes use (group_sync)
  const int lane = t & (W - 1);
  float x = c;
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, x, d, W);
    if (lane >= d) x += u;
  }
  float before = __shfl_up_sync(0xffffffffu, x, 1, W);
  if (lane == 0) before = 0.f;
  if constexpr (T > 32) {
    if (lane == 31) pad_slot(fb, t >> 5)->x = x;
    mapt::group_sync<G::GT>(G::GT ? tid / G::GT : 0);
    float e = 0.f;
    for (int w = 0; w < (t >> 5); ++w) e += pad_slot(fb, w)->x;
    before = e + before;
  }

  float run = before;
#pragma unroll
  for (int i = 0; i < P; ++i) run += s[i];
  if (last) run += sm;
  // the last thread's running sum at bin M, in every thread of the frame
  float total;
  if constexpr (T <= 32) {
    total = __shfl_sync(0xffffffffu, run, T - 1, T);
  } else {
    if (last) fb[G::FS - 1].x = run;
    mapt::group_sync<G::GT>(G::GT ? tid / G::GT : 0);
    total = fb[G::FS - 1].x;
  }
  const float thr = roll_percent * total;
  int first = M + 1;
  run = before;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    run += s[i];
    if (run >= thr && first > M) first = t * P + i;
  }
  if (last) {
    run += sm;
    if (run >= thr && first > M) first = M;
  }
  // the least over the frame's threads: shuffles, then the warps' through
  // pad slots (.y)
#pragma unroll
  for (int d = W / 2; d > 0; d >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, d));
  if constexpr (T > 32) {
    if (lane == 0) pad_slot(fb, t >> 5)->y = __int_as_float(first);
    mapt::group_sync<G::GT>(G::GT ? tid / G::GT : 0);
    for (int w = 0; w < T / 32; ++w) first = min(first, __float_as_int(pad_slot(fb, w)->y));
  }
  return __ldg(freq + (first > M ? 0 : first));
}

// K2's front end and tile (stft_kernel), then one statistic a frame, out[b *
// F + f], float32. STAT and P: bandwidth at p = P (a: norm), rolloff
// (a: roll_percent), flatness at power P (a: amin).
template <int LOG_M, int STAT, int P>
__global__ void __launch_bounds__(mapt::Geometry<LOG_M>::NT)
stft_stats_kernel(const float* __restrict__ y, long long L,
                  const float* __restrict__ win,
                  const float2* __restrict__ tw_g,
                  const float* __restrict__ freq,
                  float* __restrict__ out,
                  int hop, int F, int pad, int mode, int tiles, int total, float a) {
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
    const float* fr = seg + off + fs * hop;
    if (off & 1)
      mapt::first_pass<LOG_M, false>(v, fr, win2, fb, twp, t);
    else
      mapt::first_pass<LOG_M, true>(v, fr, win2, fb, twp, t);
    mapt::rexchange_passes<LOG_M, 1, G::GT>(fb, v, twp, t, G::GT ? tid / G::GT : 0);
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < total)
      off = mapt::stage_segment(y + static_cast<long long>(next / tiles) * L, L,
                                static_cast<long long>(next % tiles) * FT * hop - pad,
                                seg_len, mode, seg, tid, NT);

    // the emit's lanes, frames fastest: frame f, bins k0 + J*T and M - k
    const int f = tid & (FT - 1);
    const int k0 = tid >> G::LOG_FT;
    const int lo1 = mapt::rdigit_rev(LOG_M, k0), lo2 = k0 ? mapt::rdigit_rev(LOG_M, T - k0) : 0;
    if constexpr (STAT == kRolloff) {
      emit_mags<LOG_M>(buf + f * FS, tw_g, k0, lo1, lo2,
                       [](int, float s, float* stash) { *stash = s; });
      __syncthreads();
      const float r = frame_rolloff<LOG_M>(fb, freq, tid, t, a);
      if (t == 0 && f0 + fs < F) out[static_cast<long long>(b) * F + f0 + fs] = r;
    } else {
      float r;
      bool holds;
      if constexpr (STAT == kFlatness)
        holds = emit_flatness<LOG_M, P>(r, buf, f, tid, tw_g, k0, lo1, lo2, a);
      else
        holds = emit_bandwidth<LOG_M, P>(r, buf, f, tid, tw_g, freq, k0, lo1, lo2, a != 0.f);
      const int hf = tid / (NT / 32);  // the frame whose value this thread holds
      if (holds && f0 + hf < F) out[static_cast<long long>(b) * F + f0 + hf] = r;
    }
    mapt::cp_async_wait_all();
    __syncthreads();
  }
}

// Open the instances of LOG_M to the whole 227 KB once per device; the
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
  for (const void* k : {reinterpret_cast<const void*>(stft_stats_kernel<LOG_M, kBandwidth, 2>),
                        reinterpret_cast<const void*>(stft_stats_kernel<LOG_M, kBandwidth, 1>),
                        reinterpret_cast<const void*>(stft_stats_kernel<LOG_M, kRolloff, 1>),
                        reinterpret_cast<const void*>(stft_stats_kernel<LOG_M, kFlatness, 2>),
                        reinterpret_cast<const void*>(stft_stats_kernel<LOG_M, kFlatness, 1>)})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, mapt::kSmemLimit);
  opened[device] = err == cudaSuccess;
  return err;
}

// The persistent grid of kernel K at LOG_M and hop for B clips of F frames:
// SMs times resident blocks, at most one block a tile. Per device, the
// slots of the last shared-memory size launched, so the occupancy query
// runs once per size, not per call. Returns a CUDA error; grid 0 when there
// is nothing to launch.
template <auto K, int LOG_M>
int persistent_grid(int B, int hop, int F, int device, int* grid, int* tiles) {
  using G = mapt::Geometry<LOG_M>;
  static size_t sized[kMaxDevices];
  static int slots[kMaxDevices];
  const size_t smem = G::smem(hop);
  *grid = 0;
  if (smem > mapt::kSmemLimit || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (sized[device] != smem) {
    int per_sm = 0, sms = 0;
    cudaError_t err = open_smem<LOG_M>(device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, G::NT, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[device] = sms * per_sm;
    sized[device] = smem;
  }
  *tiles = (F + G::FT - 1) / G::FT;
  const long long total = static_cast<long long>(B) * *tiles;
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (total > 0) *grid = static_cast<int>(total < slots[device] ? total : slots[device]);
  return static_cast<int>(cudaSuccess);
}

template <typename OUT, int LOG_M>
int launch_m(const float* y, long long L, const float* win, const float* tw, OUT* out,
             int B, int hop, int F, int pad, int mode, int device, cudaStream_t stream) {
  using G = mapt::Geometry<LOG_M>;
  int grid, tiles;
  const int err = persistent_grid<stft_kernel<OUT, LOG_M>, LOG_M>(B, hop, F, device, &grid, &tiles);
  if (err != 0 || grid == 0) return err;
  stft_kernel<OUT, LOG_M><<<grid, G::NT, G::smem(hop), stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), out, hop, F, pad, mode, tiles, B * tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG_M, int STAT, int P>
int launch_stats_m(const float* y, long long L, const float* win, const float* tw,
                   const float* freq, float* out, int B, int hop, int F, int pad, int mode,
                   float a, int device, cudaStream_t stream) {
  using G = mapt::Geometry<LOG_M>;
  int grid, tiles;
  const int err = persistent_grid<stft_stats_kernel<LOG_M, STAT, P>, LOG_M>(B, hop, F, device,
                                                                            &grid, &tiles);
  if (err != 0 || grid == 0) return err;
  stft_stats_kernel<LOG_M, STAT, P><<<grid, G::NT, G::smem(hop), stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), freq, out, hop, F, pad, mode, tiles,
      B * tiles, a);
  return static_cast<int>(cudaGetLastError());
}

// info = {threads per block, frames per tile, dynamic shared memory per
// block, resident blocks per SM for K2, the same for K2m, for K2s (its
// bandwidth instance; all take the same shared memory)}
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
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[5], stft_stats_kernel<LOG_M, kBandwidth, 2>, G::NT, smem);
  return static_cast<int>(err);
}

// The instance of LOG_M = log2(n_fft / 2), 6 .. 12: body(std::integral_constant<int, LOG_M>)
template <typename Body>
int by_log_m(int n_fft, Body body) {
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
    case 6: return body(std::integral_constant<int, 6>());
    case 7: return body(std::integral_constant<int, 7>());
    case 8: return body(std::integral_constant<int, 8>());
    case 9: return body(std::integral_constant<int, 9>());
    case 10: return body(std::integral_constant<int, 10>());
    case 11: return body(std::integral_constant<int, 11>());
    case 12: return body(std::integral_constant<int, 12>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename OUT>
int launch(const float* y, long long L, const float* win, const float* tw, OUT* out,
           int B, int n_fft, int hop, int F, int pad, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  return by_log_m(n_fft, [&](auto lm) {
    return launch_m<OUT, decltype(lm)::value>(y, L, win, tw, out, B, hop, F, pad, mode, device, s);
  });
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

// stat: 0 bandwidth (a: norm), 1 rolloff (a: roll_percent), 2 flatness (a:
// amin); power: bandwidth's p or flatness's power, 1 or 2; out: B x F floats
extern "C" int stft_stats_launch(const float* y, long long L, const float* win,
                                 const float* tw, const float* freq, float* out, int B,
                                 int n_fft, int hop, int F, int pad, int mode, int stat,
                                 int power, float a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stat < kBandwidth || stat > kFlatness || power < 1 || power > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return by_log_m(n_fft, [&](auto lm) {
    constexpr int LOG_M = decltype(lm)::value;
    const auto go = stat == kRolloff       ? &launch_stats_m<LOG_M, kRolloff, 1>
                    : stat == kBandwidth   ? (power == 2 ? &launch_stats_m<LOG_M, kBandwidth, 2>
                                                         : &launch_stats_m<LOG_M, kBandwidth, 1>)
                    : power == 2           ? &launch_stats_m<LOG_M, kFlatness, 2>
                                           : &launch_stats_m<LOG_M, kFlatness, 1>;
    return go(y, L, win, tw, freq, out, B, hop, F, pad, mode, a, device, s);
  });
}

extern "C" int stft_geometry(int n_fft, int hop, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return by_log_m(n_fft, [&](auto lm) { return geometry_m<decltype(lm)::value>(hop, device, info); });
}
