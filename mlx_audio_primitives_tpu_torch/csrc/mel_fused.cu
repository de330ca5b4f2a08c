// K1: fused filterbank spectrogram, |rFFT(window * frame)|^p @ W.
//
// Replaces mlx_audio_primitives_tpu/kernels/mel_fused.py::melspectrogram_pallas
// (pallas_call in _mel_radix_core). W is any (n_bins, n_cols) matrix (mel,
// MFCC's mel, a centroid's [1, f] moments, chroma); the dense entry treats
// it as dense, the fast entry contracts only its nonzero band (below).
// Frames, spectra and power rows never reach device memory, and
// the output is written as (B, n_cols, F). The pitch ACF's weight, the lag
// basis, is an inverse real DFT: its own entry (mel_fused_acf_launch, below)
// computes that inverse in place of the contraction.
//
// What bounds it on this card. At the scale configuration (256 x 4 s clips,
// n_fft 2048, 128 columns) the contraction is 11.6 GFLOP: on the CUDA cores
// in FP32 it would take 0.17 ms at peak, and a loop that feeds each FMA from
// shared memory runs far below that. On the tensor cores as three TF32
// products (below) it is 35 GFLOP, 0.07 ms at peak; the FFT, window and
// power rows are 2.7 GFLOP of FP32 and the bytes 0.03 ms. What the design
// cannot shrink is W's traffic from L2: every 16-frame tile reads all of W
// (525 KB at 1,025 x 128), 1.5 GB at the scale configuration, and the
// contraction's time grows with it (PERF.md). The design:
//
// - the register-resident front end of fft_common.cuh, as K2 runs it: a
//   persistent grid over (clip, frame tile) pairs, FT frames per tile (16 up
//   to n_fft 2048), first_pass from the staged segment, rexchange_passes;
// - power rows written in place, in rounds of a few frames: each thread
//   reads bin pairs Z[k], Z[M-k] of one frame at their digit-reversed
//   positions, as K2's emit does, and puts |X[k]|^p and |X[M-k]|^p in its
//   own scratch slots in the segment buffer (the first pass has read it);
//   after a barrier that ends the round's reads of the spectra it writes
//   them in natural bin order into the frame's own buffer, split into TF32
//   hi and lo parts. There is no room for separate rows (the frame buffers
//   take 139 KB of 227 at n_fft 2048), and the values held in registers
//   through the barrier made ptxas spill at 64 registers a thread;
// - the segment of the next tile copied with cp.async during the
//   contraction, once the power rows have left the segment buffer;
// - the contraction out[col, f] = sum_k P[f, k] W[k, col] on the tensor
//   cores at FP32 accuracy, 3xTF32 on mma.sync m16n8k8: each operand x is
//   split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and the FP32
//   accumulators take lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of a product,
//   is dropped). M = 16 weight columns, N = 8 frames, so the accumulators
//   hold adjacent frames of a column and the store runs frames fastest;
// - cost follows the columns: a warp owns one m-tile of 16 columns and a
//   slice of the bins (k-steps ks, ks + KS, ...); the ceil(n_cols / 16)
//   m-tiles and KS = max(1, warps / m-tiles) slices cover the block's warps,
//   so a 2-column weight costs one m-tile, and the KS partial sums meet in
//   shared memory. W goes straight from L2 into the A fragments (each element
//   once per tile, as a shared-memory stage would read it), split there,
//   the next k-step's fragment loaded while this one's products run: shared
//   memory is full of frame buffers (15 KB free at hop 1024) and its
//   bandwidth is what the power rows' B fragments use.
//
// The fast entry (mel_fused_fast_launch, mel_fused_fast_kernel; its own
// section below) computes the contraction as 3-pass bf16 splits, the scheme
// of the JAX kernel's fast_gemm mode (mel_fused.py::_bf16_split,
// _group_dot): each operand x is split into hi = bf16_rn(x) and lo =
// bf16_rn(x - hi), and mma.sync m16n8k16 (bf16 in, FP32 accumulate) takes
// lo*hi + hi*lo + hi*hi, each k-step of 16 bins from a zero accumulator.
// hi + lo keeps ~16 of x's 24 mantissa bits, so the result is within ~1e-5
// of an exact product (the JAX package's class, 2.7e-5), where 3xTF32 is
// within ~1e-6. It reads W from a plan made once per cached table (W^T
// already split and laid out as the A fragments read it, and each 16-column
// m-tile's range of k-steps outside which its columns are zero), contracts
// only those blocks (73 of 520 at the 128-mel table: a mel filter is a
// triangle a few bins wide), the warps taking equal shares of them. A W
// given per call (a trainable filterbank) is packed into a full-range plan on the
// device first, by mel_fused_fast_pack_kernel (mel_fused_pack_launch); no call
// copies or transposes a cached table.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "fft_common.cuh"
#include "k1_plan.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kRounds = 4;  // rounds of power rows per tile (FT of them where FT < 4)

// Float offset of frame f's power row in the frame buffers: hi parts at
// [0, M], lo parts at [M+1, 2M+1]. Rows of 8 consecutive frames start on
// banks 4 apart, so a B fragment load (8 frames x 4 bins) hits 32 banks;
// frame buffers too small for the shift (M < 256) keep it at 0.
// FAST: bf16 parts, hi at [0, M] and lo at [M+4, 2M+4] of a row of M+4
// floats (lo 8-byte aligned); rows start on banks 8 apart, so each half of
// a warp's 64-bit B load (4 frames x 4 word pairs) hits 32 banks.
template <int LOG_M, bool FAST = false>
__device__ __forceinline__ int row_offset(int f) {
  constexpr int M = 1 << LOG_M;
  constexpr int FSW = 2 * mapt::rframe_stride(M);  // floats per frame buffer
  if constexpr (FAST) {
    static_assert(FSW - (M + 4) >= 31 && FSW % 2 == 0, "the shifted rows fit, 8-byte aligned");
    return f * FSW + ((8 * f - f * FSW) & 31);
  } else if constexpr (FSW - 2 * (M + 1) >= 31) {
    return f * FSW + ((4 * f - f * FSW) & 31);
  } else {
    return f * FSW;
  }
}

// v, as a value the compiler cannot hoist out of the tile loop: what is
// derived from it (a phase's indices, addresses and bounds) is computed in
// its phase of each tile instead of being kept live in registers through
// the other phases
__device__ __forceinline__ int opaque(int v) {
  int r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// sqrt.approx (the SFU's square root, within a few ulp): the IEEE sqrtf
// reaches its slow path by a call, around which ptxas saves the live
// registers to local memory
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 does: sign and magnitude are apart in the bits,
// so adding half of the 13 dropped bits and clearing them does it, in two
// integer operations (the cvt took ~6% of K1's time at the scale
// configuration, H100 80GB HBM3)
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// c += a * b on the tensor cores (m16n8k8, TF32 in, FP32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// |X[k]|^p and |X[M-k]|^p of the frame z for k = k0 + J*TP <= M/2, where
// TP (a power of two) threads share the frame and k0 < TP: the positions
// and the split of stft.cu's emit_pairs (k0 and J*TP share no bit, so the
// digit reversal of k is lo1 + rdigit_rev(J*TP), and of M-k lo2 plus a
// constant). Each value goes to the thread's own scratch slot at once,
// slot 2J (bin k) and 2J+1 (bin M-k; none for J*TP = M/2, where k = M/2):
// nothing is held in registers through the barrier before the rows are
// written, which at n_fft 2048 and 64 registers a thread made ptxas spill.
template <int LOG_M, int TP, int NT, int J = 0>
__device__ __forceinline__ void power_pairs(const float2* z, const float2* __restrict__ tw_g,
                                            float* scratch, int me, int k0, int lo1, int lo2,
                                            bool mag) {
  constexpr int M = 1 << LOG_M;
  if constexpr (J * TP <= M / 2) {
    if (k0 + J * TP <= M / 2) {
      constexpr int h1 = mapt::rdigit_rev(LOG_M, J * TP);
      constexpr int h2_0 = mapt::rdigit_rev(LOG_M, (M - J * TP) & (M - 1));
      constexpr int h2 = mapt::rdigit_rev(LOG_M, (M - (J + 1) * TP) & (M - 1));
      const float2 a = z[mapt::rpidx(lo1 + h1)];
      const float2 c = z[mapt::rpidx(lo2 + (k0 ? h2 : h2_0))];
      const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
      const float dr = 0.5f * (a.x - c.x), di = 0.5f * (a.y + c.y);
      const float2 o = mapt::cmul(__ldg(tw_g + k0 + J * TP), make_float2(di, -dr));
      const float xr = er + o.x, xi = ei + o.y;  // X[k]
      const float yr = er - o.x, yi = o.y - ei;  // X[M-k]
      const float pk = xr * xr + xi * xi, pmk = yr * yr + yi * yi;
      scratch[2 * J * NT + me] = mag ? sqrt_approx(pk) : pk;
      if constexpr (J * TP < M / 2) scratch[(2 * J + 1) * NT + me] = mag ? sqrt_approx(pmk) : pmk;
    }
    power_pairs<LOG_M, TP, NT, J + 1>(z, tw_g, scratch, me, k0, lo1, lo2, mag);
  }
}

// row[k] = hi, row[M+1+k] = lo of p (TF32); FAST: the bf16 halves hi at
// k and lo at M+4+k, and bin M as a whole word with bin M+1 zero, since the
// last k-step's B fragment reads it, and whether hi is not finite (inf or
// NaN: p is, or rounds up past the largest bf16)
template <int LOG_M, bool FAST>
__device__ __forceinline__ bool put_split(float* row, int k, float p) {
  constexpr int M = 1 << LOG_M;
  if constexpr (FAST) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(p);
    const unsigned short h = __bfloat16_as_ushort(hi);
    const unsigned short l = __bfloat16_as_ushort(__float2bfloat16_rn(p - __bfloat162float(hi)));
    if (k == M) {
      unsigned* r32 = reinterpret_cast<unsigned*>(row);
      r32[M / 2] = h;
      r32[M + 2] = l;
    } else {
      unsigned short* r16 = reinterpret_cast<unsigned short*>(row);
      r16[k] = h;
      r16[M + 4 + k] = l;
    }
    return (h & 0x7F80u) == 0x7F80u;
  } else {
    const unsigned hi = tf32_rna(p);
    row[k] = __uint_as_float(hi);
    row[M + 1 + k] = __uint_as_float(tf32_rna(p - __uint_as_float(hi)));
    return false;
  }
}

// The power row in natural bin order from the thread's scratch slots: bins
// k and M-k of each pair (bin M/2 once, bins 0 and M from k = 0); whether a
// value it wrote is not finite (FAST)
template <int LOG_M, bool FAST, int TP, int NT, int J = 0>
__device__ __forceinline__ bool write_pairs(float* row, const float* scratch, int me, int k0) {
  constexpr int M = 1 << LOG_M;
  if constexpr (J * TP <= M / 2) {
    const int k = k0 + J * TP;
    bool bad = false;
    if (k <= M / 2) {
      bad = put_split<LOG_M, FAST>(row, k, scratch[2 * J * NT + me]);
      if constexpr (J * TP < M / 2)
        bad |= put_split<LOG_M, FAST>(row, M - k, scratch[(2 * J + 1) * NT + me]);
    }
    const bool rest = write_pairs<LOG_M, FAST, TP, NT, J + 1>(row, scratch, me, k0);
    return bad || rest;
  } else {
    return false;
  }
}

// One round of power rows: frames f0r + (me mod FR) of the tile, TP =
// NT/FR threads per frame, frames fastest across lanes (as K2's emit);
// every read of the round's spectra ends at a barrier before the first
// write lands in their buffers. The thread index is read afresh on each
// side of the barrier, so no address is held through it. FAST: a warp
// that wrote a value that is not finite sets the tile's flag.
template <int LOG_M, bool FAST, int FR, int NT>
__device__ __forceinline__ void power_round(float2* buf, float* rows, float* scratch,
                                            const float2* __restrict__ tw_g, int f0r, int tid,
                                            bool mag, int* flag = nullptr) {
  constexpr int FS = mapt::rframe_stride(1 << LOG_M), TP = NT / FR;
  {
    const int me = opaque(tid), f = f0r + (me & (FR - 1)), k0 = me / FR;
    power_pairs<LOG_M, TP, NT>(buf + f * FS, tw_g, scratch, me, k0,
                               mapt::rdigit_rev(LOG_M, k0),
                               k0 ? mapt::rdigit_rev(LOG_M, TP - k0) : 0, mag);
  }
  __syncthreads();
  const int me = opaque(tid), f = f0r + (me & (FR - 1));
  const bool bad =
      write_pairs<LOG_M, FAST, TP, NT>(rows + row_offset<LOG_M, FAST>(f), scratch, me, me / FR);
  if constexpr (FAST) {
    if (__any_sync(0xffffffffu, bad) && (me & 31) == 0) *flag = 1;
  } else {
    (void)bad;
    (void)flag;
  }
}

// The A fragment (16 columns x 8 bins) of W at columns c0.., k-step kk:
// a0 = W[k][c0+g], a1 = W[k][c0+g+8], a2 = W[k+4][c0+g], a3 = W[k+4][c0+g+8]
// with k = 8*kk + q; zero past n_bins or n_cols
__device__ __forceinline__ void load_a(float (&a)[4], const float* __restrict__ W, int n_bins,
                                       int n_cols, int kk, int ca, int q) {
  const int k = 8 * kk + q;
  const bool oka = ca < n_cols, okb = ca + 8 < n_cols;
  const float* w0 = W + static_cast<size_t>(k) * n_cols + ca;
  const float* w1 = w0 + 4 * static_cast<size_t>(n_cols);
  a[0] = (k < n_bins && oka) ? __ldg(w0) : 0.f;
  a[1] = (k < n_bins && okb) ? __ldg(w0 + 8) : 0.f;
  a[2] = (k + 4 < n_bins && oka) ? __ldg(w1) : 0.f;
  a[3] = (k + 4 < n_bins && okb) ? __ldg(w1 + 8) : 0.f;
}

// One (m-tile, k-slice) unit's sums, 3xTF32: k-steps ks, ks + n_ks, ... of
// 8 bins, the A fragment of W at columns ca.. (ca = 16-column m-tile + g),
// the B fragments from the power rows, NTILE n-tiles of 8 frames
template <int LOG_M, int FT>
__device__ __forceinline__ void unit_3xtf32(float (&acc)[(FT + 7) / 8][4],
                                            const float* rows, const float* __restrict__ W,
                                            int n_cols, int n_ks, int ks, int ca, int g, int q) {
  constexpr int M = 1 << LOG_M;
  constexpr int NTILE = (FT + 7) / 8;         // n-tiles of 8 frames
  constexpr int KSTEPS = (M + 1 + 7) / 8;     // k-steps of 8 bins over n_bins = M + 1
  float a[4];
  load_a(a, W, M + 1, n_cols, ks, ca, q);
  for (int kk = ks; kk < KSTEPS; kk += n_ks) {
    float an[4];
    load_a(an, W, M + 1, n_cols, kk + n_ks, ca, q);  // zeros past the last step
    unsigned ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ahi[i] = tf32_rna(a[i]);
      alo[i] = tf32_rna(a[i] - __uint_as_float(ahi[i]));
    }
    const int k = 8 * kk + q;
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
      const int f = 8 * j + g;
      const float* r = rows + row_offset<LOG_M>(f < FT ? f : 0);
      const bool ok0 = (FT >= 8 || f < FT) && k <= M, ok1 = (FT >= 8 || f < FT) && k + 4 <= M;
      const unsigned bhi[2] = {ok0 ? __float_as_uint(r[k]) : 0u,
                               ok1 ? __float_as_uint(r[k + 4]) : 0u};
      const unsigned blo[2] = {ok0 ? __float_as_uint(r[M + 1 + k]) : 0u,
                               ok1 ? __float_as_uint(r[M + 5 + k]) : 0u};
      // the k-step's three products start from zero and join the sum
      // in an FP32 add: the tensor cores' accumulation truncates, which
      // over hundreds of k-steps into one accumulator biased the sum by
      // ~1e-5 of it (dense weights at n_fft 4096)
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, alo, bhi);
      mma_tf32(d, ahi, blo);
      mma_tf32(d, ahi, bhi);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += d[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = an[i];
  }
}

// The dense entry
template <int LOG_M>
__global__ void __launch_bounds__(mapt::Geometry<LOG_M>::NT)
mel_fused_kernel(const float* __restrict__ y, long long L,
                 const float* __restrict__ win,
                 const float2* __restrict__ tw_g,
                 const float* __restrict__ W,
                 float* __restrict__ out,
                 int hop, int F, int n_cols, int n_mt, int n_ks, int pad, int mode,
                 int power, int tiles, int total) {
  using G = mapt::Geometry<LOG_M>;
  constexpr int M = G::M, T = G::T, FT = G::FT, NT = G::NT, FS = G::FS;
  constexpr int NW = NT / 32;                 // warps
  constexpr int NTILE = (FT + 7) / 8;         // n-tiles of 8 frames
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float* rows = reinterpret_cast<float*>(smem4);
  float2* twp = buf + G::TW_OFF;
  float* seg = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + G::SEG_OFF_BYTES);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const int tid = threadIdx.x;
  const int seg_len = (FT - 1) * hop + 2 * M;

  static_assert(mapt::rtw_offset(LOG_M, mapt::plan_passes(LOG_M)) <= M, "twiddle tables fit");
  static_assert(NW * 256 <= FT * 2 * FS, "the partial sums fit in the frame buffers");
  mapt::stage_twiddles<LOG_M>(twp, tw_g, tid, NT);
  int tile = blockIdx.x;
  int off = mapt::stage_segment(y + static_cast<long long>(tile / tiles) * L, L,
                                static_cast<long long>(tile % tiles) * FT * hop - pad, seg_len,
                                mode, seg, tid, NT);
  mapt::cp_async_wait_all();
  __syncthreads();

  for (; tile < total; tile += gridDim.x) {
    {
      // the thread's index read afresh in each tile: the FFT's addresses
      // derive from it, and kept from tile to tile they would hold
      // registers that the power rows need
      const int me = opaque(tid), fs = me / T, t = me % T;
      float2* fb = buf + fs * FS;
      float2 v[mapt::kRegPoints];
      const float* fr = seg + off + fs * hop;
      if (off & 1)
        mapt::first_pass<LOG_M, false>(v, fr, win2, fb, twp, t);
      else
        mapt::first_pass<LOG_M, true>(v, fr, win2, fb, twp, t);
      mapt::rexchange_passes<LOG_M, 1, G::GT>(fb, v, twp, t, G::GT ? me / G::GT : 0);
    }
    __syncthreads();
    // power rows in R rounds of FT/R frames, through scratch slots in the
    // segment buffer, which the first pass has read. A round reads frames
    // that the earlier rounds' writes do not touch, and a thread's scratch
    // slots are its own, so a round needs no barrier before its reads.
    {
      constexpr int R = kRounds < FT ? kRounds : FT;
      constexpr int TP = NT / (FT / R);
      // scratch slots: 2 per pair, one for the last, NT floats each; they
      // fit in the segment at the least hop the radix gate admits
      constexpr int SLOTS = 2 * (M / 2 / TP) + 1;
      constexpr int HOP_MIN = M / 4 > 128 ? M / 4 : 128;
      static_assert(SLOTS * NT <= (FT - 1) * HOP_MIN + 2 * M, "scratch fits in the segment");
      const bool mag = opaque(power) == 1;
#pragma unroll
      for (int r = 0; r < R; ++r)
        power_round<LOG_M, false, FT / R, NT>(buf, rows, seg, tw_g, r * (FT / R), tid, mag);
    }
    __syncthreads();
    // the segment is free: copy the next tile's during the contraction
    const int next = tile + gridDim.x;
    if (next < total)
      off = mapt::stage_segment(y + static_cast<long long>(next / tiles) * L, L,
                                static_cast<long long>(next % tiles) * FT * hop - pad,
                                seg_len, mode, seg, tid, NT);

    // contraction: warp -> (m-tile, k-slice) units, n_mt m-tiles of 16
    // columns and n_ks k-slices (computed on the host)
    const int b = tile / tiles;
    const int f0 = (tile % tiles) * FT;
    const int me = opaque(tid), n_cols_ = opaque(n_cols);
    const int n_mt_ = opaque(n_mt), n_ks_ = opaque(n_ks);
    const int warp = me >> 5, g = (me & 31) >> 2, q = me & 3;
    const int units = n_mt_ * n_ks_;
    float acc[NTILE][4];
    for (int u = warp; u < units; u += NW) {
      const int ca = (u / n_ks_) * 16 + g, ks = u % n_ks_;
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      unit_3xtf32<LOG_M, FT>(acc, rows, W, n_cols_, n_ks_, ks, ca, g, q);
      if (n_ks_ == 1) {
        // c0, c1: column ca, frames 2q, 2q+1 of n-tile j; c2, c3: column ca + 8
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int fl = 8 * j + 2 * q + (i & 1), col = ca + 8 * (i >> 1);
            if (fl < FT && f0 + fl < F && col < n_cols_)
              out[(static_cast<long long>(b) * n_cols_ + col) * F + f0 + fl] = acc[j][i];
          }
      }
    }
    if (n_ks_ > 1) {
      // one unit per warp: its partial sums meet those of the other
      // k-slices in the frame buffers, laid out [k-slice][column][16 frames]
      __syncthreads();
      float* part = rows;
      if (warp < units) {
        const int ks = warp % n_ks_, cl = (warp / n_ks_) * 16 + g;
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            part[((ks * n_mt_ * 16) + cl + 8 * (i >> 1)) * 16 + 8 * j + 2 * q + (i & 1)] =
                acc[j][i];
      }
      __syncthreads();
      for (int o = me; o < n_mt_ * 256; o += NT) {
        const int fl = o & 15, col = o >> 4;
        if (fl < FT && f0 + fl < F && col < n_cols_) {
          float s = 0.f;
          for (int ks = 0; ks < n_ks_; ++ks) s += part[(ks * n_mt_ * 16 + col) * 16 + fl];
          out[(static_cast<long long>(b) * n_cols_ + col) * F + f0 + fl] = s;
        }
      }
    }
    mapt::cp_async_wait_all();
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The fast entry (mel_fused_fast_launch): the contraction as the JAX
// kernel's fast_gemm mode computes it, over the weight's nonzero band.
//
// It reads W from the plan whose layout csrc/k1_plan.cuh sets out.
//
// Per tile of FT frames (the dense entry's tile: 16 frames and 1,024
// threads at n_fft 2048; two 512-thread blocks of 8 frames an SM measured
// slower, PERF.md):
// - the dense entry's front end and power rows, as bf16 hi/lo rows (two bins
//   a 32-bit word); a warp that writes a value that is not finite sets the
//   tile's flag;
// - the tile's blocks in m-tile order, in equal shares to the warps (a low
//   mel m-tile spans 2-3 k-steps and a high one about 20). A warp walks its
//   share as segments, one an m-tile; each k-step's lo*hi + hi*lo + hi*hi
//   on mma.sync m16n8k16 from zero, added in FP32. A segment that is a
//   whole m-tile is stored at once. An m-tile that warps wf < ... < wl
//   share: wl's part (its first segment) goes at once to slot wl in the
//   frame buffers' tails, past the rows, which the contraction does not
//   read; the others' (each the last segment of its warp, so a warp holds
//   at most one part in registers) go to slot w at the buffers' starts,
//   over the rows, after the contraction; then one thread a sum adds the
//   slots wf .. wl-1 in warp order and wl's part;
// - with the flag set, every m-tile takes all of its k-steps: a power that
//   is not finite meets the weight's zeros there (inf * 0 = NaN in every
//   column, as in the dense product). Skipping a block of exact zeros
//   changes no finite sum.
// At the scale configuration's 128-mel table the blocks are 73 of 520.
// After the segment: the tile's flag, then the m-tiles' reduction lists
// (shared_tail_words: n_mt + 1 words past the flag's 4)
constexpr int kFlagBytes = 16;

__host__ __device__ constexpr int shared_tail_bytes(int n_mt) {
  return kFlagBytes + ((4 * (n_mt + 1) + 15) & ~15);
}

// The fast entry's tile: the dense entry's (mapt::Geometry<LOG_M, 512>
// would make two blocks of 8 frames share an SM at n_fft 2048; slower)
template <int LOG_M>
using FastGeometry = mapt::Geometry<LOG_M>;

// Registers are held to 64 a thread where a 512-thread block leaves room
// for a second on the SM (n_fft 1024, as the dense entry's); from n_fft
// 4096 on the frame buffers leave room for one block.
constexpr int fast_min_blocks(int log_m, int nt) { return nt == 512 && log_m <= 10 ? 2 : 1; }

// The warps that hold the first and the last block of m-tile mt, blocks
// [c0, c1) of tot shared out as warp w's [w tot / NW, (w + 1) tot / NW),
// as wf | wl << 16
template <int NW>
__device__ __forceinline__ int share_ends(int c0, int c1, int tot) {
  return ((c0 + 1) * NW - 1) / tot | ((c1 * NW - 1) / tot) << 16;
}

// The warps with a share of tot blocks, as bit w
template <int NW>
__device__ __forceinline__ unsigned share_mask(int tot) {
  unsigned mask = 0;
  for (int w = 0; w < NW; ++w) mask |= (w * tot / NW < (w + 1) * tot / NW ? 1u : 0u) << w;
  return mask;
}

// Block offset and first k-step of m-tile mt: the plan's, or every k-step's
// (full)
__device__ __forceinline__ int band_cum(const int* __restrict__ plan, int mt, bool full,
                                        int ksteps) {
  return full ? mt * ksteps : __ldg(plan + mapt::kPlanHeader + mt);
}
__device__ __forceinline__ int band_k0(const int* __restrict__ plan, int n_mt, int mt,
                                       bool full) {
  return full ? 0 : __ldg(plan + mapt::kPlanHeader + n_mt + 1 + mt);
}

// The sums of k-steps [kb, ke) of the m-tile whose column ca = c0 + g the
// thread serves: its A registers from wq, the plan's words at (ca, k-step
// 0) for thread q (column ca + 8 lies 8 columns on), zero for a column past
// n_cols (ok0, ok1 false: the padding is not loaded, so a 12-column weight's
// words stay in L1 from tile to tile; loading the next k-step's ahead made
// ptxas spill at 64 registers); the B registers are
// the row words 8 kk + 2q and + 1 (bins 16 kk + 4q .. +3), one 8-byte load
// of the hi row and one of the lo row; words past bin M (word M/2) are zero
template <int LOG_M, int FT>
__device__ __forceinline__ void band_unit(float (&acc)[(FT + 7) / 8][4], const float* rows,
                                          const uint4* __restrict__ wq, int kb, int ke, int g,
                                          int q, bool ok0, bool ok1) {
  constexpr int M = 1 << LOG_M;
  constexpr int NTILE = (FT + 7) / 8;
  constexpr int KSTEPS = M / 16 + 1;        // k-steps of 16 bins over n_bins = M + 1
  constexpr int NEXT_COL = 8 * KSTEPS * 4;  // uint4s from column ca to ca + 8
  const uint4* w = wq + 4 * kb;
  for (int kk = kb; kk < ke; ++kk, w += 4) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const uint4 a0 = ok0 ? __ldg(w) : z, a1 = ok1 ? __ldg(w + NEXT_COL) : z;
    const unsigned ahi[4] = {a0.x, a1.x, a0.y, a1.y};
    const unsigned alo[4] = {a0.z, a1.z, a0.w, a1.w};
    const int wd = 8 * kk + 2 * q;
#pragma unroll
    for (int j = 0; j < NTILE; ++j) {
      const int f = 8 * j + g;
      const uint2* r =
          reinterpret_cast<const uint2*>(rows + row_offset<LOG_M, true>(f < FT ? f : 0));
      const bool ok0 = (FT >= 8 || f < FT) && wd <= M / 2;
      const bool ok1 = (FT >= 8 || f < FT) && wd + 1 <= M / 2;
      const uint2 h = r[wd / 2], l = r[M / 4 + 1 + wd / 2];
      const unsigned bhi[2] = {ok0 ? h.x : 0u, ok1 ? h.y : 0u};
      const unsigned blo[2] = {ok0 ? l.x : 0u, ok1 ? l.y : 0u};
      // from zero each k-step, as unit_3xtf32
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mapt::mma_bf16(d, alo, bhi);
      mapt::mma_bf16(d, ahi, blo);
      mapt::mma_bf16(d, ahi, bhi);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += d[i];
    }
  }
}

// acc -> out: c0, c1 column ca, frames 2q, 2q+1 of n-tile j; c2, c3 column
// ca + 8
template <int FT>
__device__ __forceinline__ void store_sums(float* __restrict__ out,
                                           const float (&acc)[(FT + 7) / 8][4], int b, int f0,
                                           int F, int n_cols, int ca, int q) {
#pragma unroll
  for (int j = 0; j < (FT + 7) / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int fl = 8 * j + 2 * q + (i & 1), col = ca + 8 * (i >> 1);
      if (fl < FT && f0 + fl < F && col < n_cols)
        out[(static_cast<long long>(b) * n_cols + col) * F + f0 + fl] = acc[j][i];
    }
}

// Word of frame fl, column cl of slot s of the warps' parts, column cl in
// frame buffer cl mod FT: the parts stored at once (TAIL) past the words
// the rows' B loads reach, which the contraction does not read; those held
// to the end of the contraction at the buffer's start, over the rows
template <int LOG_M, int FT, int NW, int FP, bool TAIL>
__device__ __forceinline__ int part_word(int s, int cl, int fl) {
  constexpr int M = 1 << LOG_M, FSW = 2 * mapt::rframe_stride(M);
  constexpr int TAIL0 = M + 40;  // past the M + 10 words a row's B loads reach, and its shift
  constexpr int SLOTS = (16 + FT - 1) / FT * NW * FP;  // words of a buffer's slots
  static_assert(SLOTS <= TAIL0 && TAIL0 + SLOTS <= FSW, "the parts fit in the frame buffers");
  return (cl % FT) * FSW + (TAIL ? TAIL0 : 0) + ((cl / FT) * NW + s) * FP + fl;
}

// acc -> slot s of the tail parts (TAIL) or of the held parts
template <int LOG_M, int FT, int NW, int FP, bool TAIL>
__device__ __forceinline__ void put_part(float* part, const float (&acc)[(FT + 7) / 8][4], int s,
                                         int g, int q) {
#pragma unroll
  for (int j = 0; j < (FT + 7) / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cl = g + 8 * (i >> 1), fl = 8 * j + 2 * q + (i & 1);
      part[part_word<LOG_M, FT, NW, FP, TAIL>(s, cl, fl)] = acc[j][i];
    }
}

template <int LOG_M>
__global__ void __launch_bounds__(FastGeometry<LOG_M>::NT,
                                  fast_min_blocks(LOG_M, FastGeometry<LOG_M>::NT))
mel_fused_fast_kernel(const float* __restrict__ y, long long L,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw_g,
                      const int* __restrict__ plan,
                      float* __restrict__ out,
                      int hop, int F, int n_cols, int n_mt, int blocks, int pad, int mode,
                      int power, int tiles, int total) {
  using G = FastGeometry<LOG_M>;
  constexpr int M = G::M, T = G::T, FT = G::FT, NT = G::NT, FS = G::FS;
  constexpr int NW = NT / 32;          // warps
  constexpr int NTILE = (FT + 7) / 8;  // n-tiles of 8 frames
  constexpr int FP = 8 * NTILE;        // frames of a partial sum's column
  constexpr int KSTEPS = M / 16 + 1;
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float* rows = reinterpret_cast<float*>(smem4);
  float2* twp = buf + G::TW_OFF;
  float* seg = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + G::SEG_OFF_BYTES);
  // past the segment: the tile's flag, then the band's shares, which every
  // tile without the flag takes: for each m-tile its warps' ends
  // (share_ends), then the warps with a share. Their address is taken
  // afresh where they are used (from opaque(hop)): kept through the tile
  // loop, it and W's address held registers that the FFT needs.
  auto flag_at = [&](int h) {
    return reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) + G::smem(h));
  };
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const int tid = threadIdx.x;
  const int seg_len = (FT - 1) * hop + 2 * M;

  static_assert(mapt::rtw_offset(LOG_M, mapt::plan_passes(LOG_M)) <= M, "twiddle tables fit");
  static_assert(NW <= 32, "a warp's share is a bit of a word");
  mapt::stage_twiddles<LOG_M>(twp, tw_g, tid, NT);
  for (int mt = tid; mt <= n_mt; mt += NT)
    flag_at(hop)[4 + mt] = mt < n_mt ? share_ends<NW>(__ldg(plan + mapt::kPlanHeader + mt),
                                                __ldg(plan + mapt::kPlanHeader + mt + 1), blocks)
                         : static_cast<int>(share_mask<NW>(blocks));
  int tile = blockIdx.x;
  int off = mapt::stage_segment(y + static_cast<long long>(tile / tiles) * L, L,
                                static_cast<long long>(tile % tiles) * FT * hop - pad, seg_len,
                                mode, seg, tid, NT);
  mapt::cp_async_wait_all();
  __syncthreads();

  for (; tile < total; tile += gridDim.x) {
    if (tid == 0) *flag_at(opaque(hop)) = 0;  // the last tile's reads ended at its last barrier
    {
      // the forward transform, as the dense entry's
      const int me = opaque(tid), fs = me / T, t = me % T;
      float2* fb = buf + fs * FS;
      float2 v[mapt::kRegPoints];
      const float* fr = seg + off + fs * hop;
      if (off & 1)
        mapt::first_pass<LOG_M, false>(v, fr, win2, fb, twp, t);
      else
        mapt::first_pass<LOG_M, true>(v, fr, win2, fb, twp, t);
      mapt::rexchange_passes<LOG_M, 1, G::GT>(fb, v, twp, t, G::GT ? me / G::GT : 0);
    }
    __syncthreads();
    // the power rows, as the dense entry's, in bf16 halves
    {
      constexpr int R = kRounds < FT ? kRounds : FT;
      constexpr int TP = NT / (FT / R);
      constexpr int SLOTS = 2 * (M / 2 / TP) + 1;
      constexpr int HOP_MIN = M / 4 > 128 ? M / 4 : 128;
      static_assert(SLOTS * NT <= (FT - 1) * HOP_MIN + 2 * M, "scratch fits in the segment");
      const bool mag = opaque(power) == 1;
      int* flag = flag_at(opaque(hop));
#pragma unroll
      for (int r = 0; r < R; ++r)
        power_round<LOG_M, true, FT / R, NT>(buf, rows, seg, tw_g, r * (FT / R), tid, mag, flag);
    }
    __syncthreads();
    // the segment is free: copy the next tile's during the contraction
    const int next = tile + gridDim.x;
    if (next < total)
      off = mapt::stage_segment(y + static_cast<long long>(next / tiles) * L, L,
                                static_cast<long long>(next % tiles) * FT * hop - pad,
                                seg_len, mode, seg, tid, NT);

    // the contraction: warp w takes blocks [w tot / NW, (w + 1) tot / NW)
    const int b = tile / tiles;
    const int f0 = (tile % tiles) * FT;
    {
      const int me = opaque(tid), warp = me >> 5, g = (me & 31) >> 2, q = me & 3;
      const int n_mt_ = opaque(n_mt), n_cols_ = opaque(n_cols);
      const bool full = *flag_at(opaque(hop)) != 0;
      const int tot = full ? n_mt_ * KSTEPS : opaque(blocks);
      const uint4* wplan = reinterpret_cast<const uint4*>(plan + mapt::plan_w_offset(n_mt_));
      const int b0 = warp * tot / NW, b1 = (warp + 1) * tot / NW;
      float acc[NTILE][4];
      bool held = false;
      int mt = 0;
      if (b0 < b1)
        while (band_cum(plan, mt + 1, full, KSTEPS) <= b0) ++mt;
      for (int bb = b0; bb < b1; ++mt) {
        const int c0 = band_cum(plan, mt, full, KSTEPS), c1 = band_cum(plan, mt + 1, full, KSTEPS);
        const int e = c1 < b1 ? c1 : b1, k0 = band_k0(plan, n_mt_, mt, full);
        const int ca = 16 * mt + g;
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
        band_unit<LOG_M, FT>(acc, rows, wplan + static_cast<size_t>(ca) * KSTEPS * 4 + q,
                             k0 + bb - c0, k0 + e - c0, g, q, ca < n_cols_, ca + 8 < n_cols_);
        // the whole m-tile is stored; the part of the warp that holds an
        // m-tile's last block goes to its tail slot; a part of an m-tile
        // that goes on past b1 (the warp's last segment) is held
        held = e < c1;
        if (bb == c0 && !held)
          store_sums<FT>(out, acc, b, f0, F, n_cols_, ca, q);
        else if (!held)
          put_part<LOG_M, FT, NW, FP, true>(rows, acc, warp, g, q);
        bb = e;
      }
      __syncthreads();  // every warp's reads of the rows are done
      if (held) put_part<LOG_M, FT, NW, FP, false>(rows, acc, warp, g, q);
    }
    __syncthreads();
    {
      // the m-tiles that more than one warp took: their parts, in warp
      // order, frames fastest across lanes
      const int me = opaque(tid), n_mt_ = opaque(n_mt), n_cols_ = opaque(n_cols);
      const int* flag = flag_at(opaque(hop));
      const int* ends = flag + 4;
      const bool full = *flag != 0;
      const int tot = n_mt_ * KSTEPS;  // the full shares, where the flag is set
      const unsigned mask = full ? share_mask<NW>(tot) : static_cast<unsigned>(ends[n_mt_]);
      for (int o = me; o < n_mt_ * 16 * FP; o += NT) {
        const int fl = o % FP, cl = (o / FP) % 16, mt = o / (16 * FP), col = 16 * mt + cl;
        if (fl >= FT || f0 + fl >= F || col >= n_cols_) continue;
        const int e = full ? share_ends<NW>(mt * KSTEPS, (mt + 1) * KSTEPS, tot) : ends[mt];
        const int wf = e & 0xFFFF, wl = e >> 16;
        if (wf == wl) continue;  // stored whole by one warp
        float s = rows[part_word<LOG_M, FT, NW, FP, false>(wf, cl, fl)];
        for (int w = wf + 1; w < wl; ++w)
          if (mask >> w & 1) s += rows[part_word<LOG_M, FT, NW, FP, false>(w, cl, fl)];
        out[(static_cast<long long>(b) * n_cols_ + col) * F + f0 + fl] =
            s + rows[part_word<LOG_M, FT, NW, FP, true>(wl, cl, fl)];
      }
    }
    mapt::cp_async_wait_all();
    __syncthreads();
  }
}

// A full-range plan from a W given per call, (n_bins, n_cols) at strides
// (s_bin, s_col) floats: its header and ranges, and W^T split as
// csrc/k1_plan.cuh lays it out, one thread a (column, k-step, q); zero past
// n_bins or n_cols
__global__ void mel_fused_fast_pack_kernel(const float* __restrict__ W, long long s_bin,
                                           long long s_col, int n_bins, int n_cols, int n_mt,
                                           int ksteps, int* __restrict__ plan) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int off = mapt::plan_w_offset(n_mt);
  if (i < off) {
    const int mt = i - mapt::kPlanHeader;
    plan[i] = i == 0 ? mapt::kPlanMagic
              : i == 1 ? n_cols
              : i == 2 ? n_mt
              : i == 3 ? ksteps
              : i == 4 ? n_mt * ksteps
              : mt >= 0 && mt <= n_mt ? mt * ksteps
                                      : 0;
  }
  if (i >= 64 * n_mt * ksteps) return;
  const int q = i & 3, kk = (i >> 2) % ksteps, c = (i >> 2) / ksteps;
  float x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = 16 * kk + 4 * q + r;
    x[r] = k < n_bins && c < n_cols ? W[k * s_bin + c * s_col] : 0.f;
  }
  unsigned h0, l0, h1, l1;
  mapt::split_bf16x2(x[0], x[1], h0, l0);
  mapt::split_bf16x2(x[2], x[3], h1, l1);
  reinterpret_cast<uint4*>(plan + off)[i] = make_uint4(h0, h1, l0, l1);
}


// ---------------------------------------------------------------------------
// The ACF entry (mel_fused_acf_launch): K1 at the pitch ACF's weight.
//
// Replaces the same pallas_call at the geometry of the framewise ACF
// (mlx_audio_primitives_tpu/ops/pitch.py::_framewise_acf_fused: the boxcar
// over half the transform as the window, the lag basis as W, power 2). The
// lag basis (kernels/mel_fused.py::acf_lag_basis) is cos(2 pi k l / N) / N
// with the interior bins doubled: the inverse real DFT at lag 0 and lags
// [lo, hi). So what K1 computes there is
//   out[b, 0, f] = r_f[0],  out[b, 1 + l - lo, f] = r_f[l],
//   r_f = irfft_N(|rDFT_N(win * frame_f)|^2),
// and this entry computes it as that inverse, reading no weight.
//
// What bounds it on this card. At 64 x 30 s, n_fft 4096, hop 512 and 432
// lags the two real FFTs a frame, the window and the powers are 21 GFLOP
// of FP32 (0.32 ms at the FP32 peak) and the bytes 313 MB (0.09 ms), so
// operations. The dense entry's contraction read the 3.5 MB weight from L2
// once per 4-frame tile (~73 GB a call at that shape). The design, per
// tile of FT frames:
//
// - K1's forward front end as it is: the segment staged with cp.async,
//   first_pass, rexchange_passes; the next tile's segment is staged as soon
//   as every first pass has read this one's, during the rest of the tile;
// - the power of each bin pair feeds the inverse's input straight away: a
//   thread reads Z[k] and Z[M-k] of the bins its own butterflies of the
//   inverse's pass 0 hold (K3's map: u = t and S0 - t where pass 0 has
//   radix 8, so each bin is read once), splits the real FFT into X[k] and
//   X[M-k] as the emits do, and packs |X[k]|^2 and |X[M-k]|^2 as real bins
//   (irfft_pack's algebra) into Y[k] and Y[M-k], three floats a pair in
//   its registers; after a barrier of the frame's threads (every read of
//   the spectrum is done) it runs pass 0 on them and stores them over the
//   spectrum, in the frame's own buffer;
// - the inverse's later passes, rexchange_passes as in K3;
// - the lags read where the passes left them: sample 2m and 2m+1 are
//   (Re, -Im) of point m at rpidx(rdigit_rev(m)) (K3's overlap-add reads
//   them so); lanes are frames fastest, so a warp stores FT consecutive
//   frames of each lag.
// No hi/lo rows, scratch or partial sums: the frame buffers, the twiddle
// tables and the segment are the whole shared memory (108.6 KB at n_fft
// 4096, hop 512: two blocks an SM). tests/test_torch_port_acf_plan.py
// models the maps and the arithmetic in NumPy.

// The inverse's input at the bin pair (k, M-k) from the spectrum of one
// frame at z: a = Z[k] at za, c = Z[M-k] at zc (Z[0] for k = 0) and
// w = W_N^k. The real FFT's bins are X[k] = E + w O and X[M-k] =
// conj(E - w O), as in the emits. Their powers enter irfft_pack as real
// bins, where its algebra reduces to Y[k] = (s + a, -b) and Y[M-k] =
// (s - a, -b), with s = (P_k + P_{M-k}) / N, d = (P_k - P_{M-k}) / N,
// a = d w.y and b = d w.x (1/N exact): three floats hold both through the
// barrier before pass 0.
struct YPair {
  float s, a, b;
};

template <int LOG_M>
__device__ __forceinline__ YPair acf_pair(const float2* z, int za, int zc, float2 w) {
  constexpr float kScale = 0.5f / (1 << LOG_M);
  const float2 a = z[za], c = z[zc];
  const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
  const float dr = 0.5f * (a.x - c.x), di = 0.5f * (a.y + c.y);
  const float2 o = mapt::cmul(w, make_float2(di, -dr));
  const float xr = er + o.x, xi = ei + o.y;  // X[k]
  const float yr = er - o.x, yi = o.y - ei;  // X[M-k]
  const float pk = xr * xr + xi * xi, pmk = yr * yr + yi * yi;
  const float d = (pk - pmk) * kScale;
  return {(pk + pmk) * kScale, d * w.y, d * w.x};
}

__device__ __forceinline__ float2 y_k(YPair p) { return make_float2(p.s + p.a, -p.b); }
__device__ __forceinline__ float2 y_mk(YPair p) { return make_float2(p.s - p.a, -p.b); }

// The inverse's pass 0 of the frame at fb, whose buffer holds its forward
// spectrum Z (digit-reversed), from thread t of the frame's threads (group
// g of GT): the Y of its butterflies' points (acf_pair), a barrier of the
// frame's threads, the radix-R0 butterflies and their twiddles, the
// stores. Radix 8: butterflies u0 = t and u1 = S0 - t, whose points
// k = t + r*S0 and M - k pair up (point r of u0 with point 7 - r of u1),
// so each pair of bins is read once and held as one YPair; thread 0 owns
// u0 = 0 and u1 = T, whose points pair up inside each (r with 8 - r, and
// r with 7 - r), with Y[0] = (s, -b) (a = 0 at w = 1) and Y[M/2] = (s, 0)
// (d = 0) in one YPair. The twiddles W_N^{t + r*S0} are W_N^t W_16^r
// (S0 = N/16). Radix 16: butterfly t alone; the partners M - k of its
// points are thread S0 - t's, so each pair is read by both threads.
// k = t + r*S0 and its partner split into bits that do not overlap, so
// each digit reversal is one done at run time plus a constant.
template <int LOG_M, int GT>
__device__ __forceinline__ void acf_inverse_first_pass(float2 (&v)[mapt::kRegPoints], float2* fb,
                                                       const float2* __restrict__ tw_g,
                                                       const float2* twp, int t, int g) {
  constexpr int M = 1 << LOG_M, T = M >> mapt::kRegBits;
  constexpr int B0 = mapt::plan_bits(LOG_M, 0), R0 = 1 << B0, S0 = M / R0;
  const float2* tw0 = twp + mapt::rtw_offset(LOG_M, 0);
  if constexpr (R0 == 8) {
    static_assert(S0 == 2 * T, "two radix-8 butterflies a thread");
    YPair p[R0];
    if (t != 0) {
      // p[r]: k = t + r*S0
      const int lo1 = mapt::rdigit_rev(LOG_M, t), lo2 = mapt::rdigit_rev(LOG_M, S0 - t);
      const float2 wt = __ldg(tw_g + t);
#pragma unroll
      for (int r = 0; r < R0; ++r)
        p[r] = acf_pair<LOG_M>(fb, mapt::rpidx(lo1 + mapt::rdigit_rev(LOG_M, r * S0)),
                               mapt::rpidx(lo2 + mapt::rdigit_rev(LOG_M, (R0 - 1 - r) * S0)),
                               r ? mapt::cmul(wt, mapt::w16(r)) : wt);
    } else {
      // p[r], r < 4: k = T + r*S0; p[4 + r], 0 < r < 4: k = r*S0;
      // p[4]: Y[0] and Y[M/2]
      const float2 wT = __ldg(tw_g + T);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[r] = acf_pair<LOG_M>(fb, mapt::rpidx(mapt::rdigit_rev(LOG_M, T + r * S0)),
                               mapt::rpidx(mapt::rdigit_rev(LOG_M, T + (R0 - 1 - r) * S0)),
                               r ? mapt::cmul(wT, mapt::w16(r)) : wT);
#pragma unroll
      for (int r = 1; r < 4; ++r)
        p[4 + r] = acf_pair<LOG_M>(fb, mapt::rpidx(mapt::rdigit_rev(LOG_M, r * S0)),
                                   mapt::rpidx(mapt::rdigit_rev(LOG_M, (R0 - r) * S0)),
                                   mapt::w16(r));
      const YPair e0 = acf_pair<LOG_M>(fb, 0, 0, mapt::w16(0));
      const YPair e4 = acf_pair<LOG_M>(fb, mapt::rpidx(mapt::rdigit_rev(LOG_M, M / 2)),
                                       mapt::rpidx(mapt::rdigit_rev(LOG_M, M / 2)), mapt::w16(4));
      p[4] = {e0.s, e4.s, e0.b};
    }
    mapt::group_sync<GT>(g);  // every read of the frame's spectrum is done
    if (t != 0) {
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        v[r] = y_k(p[r]);
        v[2 * R0 - 1 - r] = y_mk(p[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[R0 + r] = y_k(p[r]);
        v[2 * R0 - 1 - r] = y_mk(p[r]);
      }
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        v[r] = y_k(p[4 + r]);
        v[R0 - r] = y_mk(p[4 + r]);
      }
      v[0] = make_float2(p[4].s, -p[4].b);
      v[R0 / 2] = make_float2(p[4].a, 0.f);
    }
    const int u1 = t ? S0 - t : T;
    mapt::dft_regs<B0, 0>(v);
    mapt::rtwiddle<S0, 0, 1, R0>(v, tw0, t);
    mapt::store_butterfly<S0, R0, 0>(v, fb, t);
    mapt::dft_regs<B0, R0>(v);
    mapt::rtwiddle<S0, R0, 1, R0>(v, tw0, u1);
    mapt::store_butterfly<S0, R0, R0>(v, fb, u1);
  } else {
    static_assert(R0 == 16 && S0 == T, "one radix-16 butterfly a thread");
    const int lo1 = mapt::rdigit_rev(LOG_M, t), lo2 = t ? mapt::rdigit_rev(LOG_M, S0 - t) : 0;
#pragma unroll
    for (int r = 0; r < R0; ++r)
      v[r] = y_k(acf_pair<LOG_M>(
          fb, mapt::rpidx(lo1 + mapt::rdigit_rev(LOG_M, r * S0)),
          mapt::rpidx(lo2 + (t ? mapt::rdigit_rev(LOG_M, (R0 - 1 - r) * S0)
                               : mapt::rdigit_rev(LOG_M, ((R0 - r) & (R0 - 1)) * S0))),
          __ldg(tw_g + t + r * S0)));
    mapt::group_sync<GT>(g);  // every read of the frame's spectrum is done
    mapt::dft_regs<B0, 0>(v);
    mapt::rtwiddle<S0, 0, 1, R0>(v, tw0, t);
    mapt::store_butterfly<S0, R0, 0>(v, fb, t);
  }
}

// Registers are held to 64 a thread (1024 threads an SM) where pass 0 has
// radix 8, as in K3's instances; radix 16 holds 32 bins at once.
template <int LOG_M>
__global__ void __launch_bounds__(mapt::Geometry<LOG_M>::NT,
                                  mapt::plan_bits(LOG_M, 0) == 4
                                      ? 1
                                      : mapt::kMaxThreads / mapt::Geometry<LOG_M>::NT)
mel_fused_acf_kernel(const float* __restrict__ y, long long L,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw_g,
                     float* __restrict__ out,
                     int hop, int F, int lo, int n_out, int pad, int mode, int tiles, int total) {
  using G = mapt::Geometry<LOG_M>;
  constexpr int M = G::M, T = G::T, FT = G::FT, NT = G::NT, FS = G::FS;
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);
  float2* twp = buf + G::TW_OFF;
  float* seg = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + G::SEG_OFF_BYTES);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const int tid = threadIdx.x;
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
    {
      // the forward transform, as the dense entry's
      const int me = opaque(tid), fs = me / T, t = me % T;
      float2* fb = buf + fs * FS;
      float2 v[mapt::kRegPoints];
      const float* fr = seg + off + fs * hop;
      if (off & 1)
        mapt::first_pass<LOG_M, false>(v, fr, win2, fb, twp, t);
      else
        mapt::first_pass<LOG_M, true>(v, fr, win2, fb, twp, t);
      mapt::rexchange_passes<LOG_M, 1, G::GT>(fb, v, twp, t, G::GT ? me / G::GT : 0);
    }
    __syncthreads();  // the spectra are complete and the segment is read
    // copy the next tile's segment during the inverse and the emit
    const int next = tile + gridDim.x;
    if (next < total)
      off = mapt::stage_segment(y + static_cast<long long>(next / tiles) * L, L,
                                static_cast<long long>(next % tiles) * FT * hop - pad,
                                seg_len, mode, seg, tid, NT);
    {
      // the inverse of the powers, in the frame's own buffer: its pass 0
      const int me = opaque(tid), fs = me / T, t = me % T, g = G::GT ? me / G::GT : 0;
      float2 v[mapt::kRegPoints];
      acf_inverse_first_pass<LOG_M, G::GT>(v, buf + fs * FS, tw_g, twp, t, g);
    }
    {
      // its later passes, with the thread's indices read afresh: derived
      // once for the whole inverse, they made ptxas spill at 64 registers
      const int me = opaque(tid), fs = me / T, t = me % T, g = G::GT ? me / G::GT : 0;
      float2 v[mapt::kRegPoints];
      mapt::rexchange_passes<LOG_M, 1, G::GT>(buf + fs * FS, v, twp, t, g);
    }
    __syncthreads();  // every frame's lags are in place
    {
      // column j holds lag 0 (j = 0) or lag lo + j - 1; lanes frames fastest
      const int b = tile / tiles, f0 = (tile % tiles) * FT;
      const int me = opaque(tid), fl = me & (FT - 1), n_out_ = opaque(n_out);
      float* ob = out + static_cast<long long>(b) * n_out_ * F + f0 + fl;
      if (f0 + fl < F) {
        for (int j = me >> G::LOG_FT; j < n_out_; j += NT / FT) {
          const int l = j ? lo + j - 1 : 0;
          const float2 z = buf[fl * FS + mapt::rpidx(mapt::rdigit_rev(LOG_M, l >> 1))];
          ob[static_cast<long long>(j) * F] = (l & 1) ? -z.y : z.x;
        }
      }
    }
    mapt::cp_async_wait_all();
    __syncthreads();
  }
}

// K1's entries: each has an instance per LOG_M
enum Entry { kDense = 0, kAcf = 1, kFast = 2 };

// The instances: n_fft = 2^(LOG_M+1), 128 .. 8192
#define MAPT_K1_LOG_MS(X) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

template <int LOG_M, int ENTRY>
const void* kernel_of() {
  if constexpr (ENTRY == kAcf)
    return reinterpret_cast<const void*>(mel_fused_acf_kernel<LOG_M>);
  else if constexpr (ENTRY == kFast)
    return reinterpret_cast<const void*>(mel_fused_fast_kernel<LOG_M>);
  else
    return reinterpret_cast<const void*>(mel_fused_kernel<LOG_M>);
}

// An entry's tile geometry, and the shared memory of its blocks at a hop
template <int LOG_M, int ENTRY>
using GeometryOf =
    std::conditional_t<ENTRY == kFast, FastGeometry<LOG_M>, mapt::Geometry<LOG_M>>;

template <int LOG_M, int ENTRY>
size_t smem_of(int hop, int n_mt = 8) {
  return GeometryOf<LOG_M, ENTRY>::smem(hop) + (ENTRY == kFast ? shared_tail_bytes(n_mt) : 0);
}

// Open an instance to the whole 227 KB once per device; the blocks a
// launch keeps resident follow from the shared memory it asks for.
template <int LOG_M, int ENTRY>
cudaError_t open_smem(int device) {
  static bool opened[kMaxDevices];
  if (opened[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_of<LOG_M, ENTRY>(), cudaFuncAttributeMaxDynamicSharedMemorySize, mapt::kSmemLimit);
  opened[device] = err == cudaSuccess;
  return err;
}

// Per device and instance: the grid of the last shared-memory size launched
// (SMs times resident blocks), so the occupancy query runs once per size,
// not per call
template <int LOG_M, int ENTRY>
cudaError_t grid_slots(size_t smem, int device, int* grid) {
  using G = GeometryOf<LOG_M, ENTRY>;
  static size_t sized[kMaxDevices];
  static int slots[kMaxDevices];
  if (sized[device] != smem) {
    int per_sm = 0, sms = 0;
    cudaError_t err = open_smem<LOG_M, ENTRY>(device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<LOG_M, ENTRY>(),
                                                          G::NT, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots[device] = sms * per_sm;
    sized[device] = smem;
  }
  *grid = slots[device];
  return cudaSuccess;
}

// The grid of a K1 launch (the dense or the fast entry): SMs times resident
// blocks, at most one block a tile; 0 where there is nothing to do
template <int LOG_M, int ENTRY>
int contract_grid(size_t smem, int B, int F, int n_cols, int hop, int device, int* tiles,
                  int* total, int* grid) {
  using G = GeometryOf<LOG_M, ENTRY>;
  *grid = 0;
  // the power rows' scratch takes the segment buffer of the least hop the
  // radix gate admits (n_fft/hop <= 8, hop >= 128)
  if (smem > mapt::kSmemLimit || 8 * hop < 2 * G::M || hop < 128 || device < 0 ||
      device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int slots = 0;
  const cudaError_t err = grid_slots<LOG_M, ENTRY>(smem, device, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tiles = (F + G::FT - 1) / G::FT;
  const long long all = static_cast<long long>(B) * *tiles;
  if (all <= 0 || n_cols <= 0) return static_cast<int>(cudaSuccess);
  if (all > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *total = static_cast<int>(all);
  *grid = static_cast<int>(all < slots ? all : slots);
  return static_cast<int>(cudaSuccess);
}

template <int LOG_M>
int launch_m(const float* y, long long L, const float* win, const float* tw, const float* W,
             float* out, int B, int hop, int F, int n_cols, int pad, int mode, int power,
             int device, cudaStream_t stream) {
  using G = mapt::Geometry<LOG_M>;
  const size_t smem = smem_of<LOG_M, kDense>(hop);
  int tiles = 0, total = 0, grid = 0;
  const int err = contract_grid<LOG_M, kDense>(smem, B, F, n_cols, hop, device, &tiles, &total,
                                               &grid);
  if (err != 0 || grid == 0) return err;
  // m-tiles of 16 columns; k-slices per m-tile to fill the block's warps
  const int n_mt = (n_cols + 15) / 16;
  const int n_ks = G::NT / 32 / n_mt > 1 ? G::NT / 32 / n_mt : 1;
  mel_fused_kernel<LOG_M><<<grid, G::NT, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), W, out, hop, F, n_cols, n_mt, n_ks, pad,
      mode, power, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

// The fast entry from a plan of `blocks` blocks
template <int LOG_M>
int fast_launch_m(const float* y, long long L, const float* win, const float* tw,
                  const int* plan, float* out, int B, int hop, int F, int n_cols, int blocks,
                  int pad, int mode, int power, int device, cudaStream_t stream) {
  using G = FastGeometry<LOG_M>;
  constexpr int KSTEPS = G::M / 16 + 1;
  const int n_mt = (n_cols + 15) / 16;
  const size_t smem = smem_of<LOG_M, kFast>(hop, n_mt);
  if (blocks < n_mt || blocks > n_mt * KSTEPS) return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 0, total = 0, grid = 0;
  const int err = contract_grid<LOG_M, kFast>(smem, B, F, n_cols, hop, device, &tiles, &total,
                                              &grid);
  if (err != 0 || grid == 0) return err;
  mel_fused_fast_kernel<LOG_M><<<grid, G::NT, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), plan, out, hop, F, n_cols, n_mt, blocks,
      pad, mode, power, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG_M>
int acf_launch_m(const float* y, long long L, const float* win, const float* tw, float* out,
                 int B, int hop, int F, int lo, int hi, int pad, int mode, int device,
                 cudaStream_t stream) {
  using G = mapt::Geometry<LOG_M>;
  const size_t smem = smem_of<LOG_M, kAcf>(hop);
  if (smem > mapt::kSmemLimit || hop < 1 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (lo < 0 || hi <= lo || hi > 2 * G::M) return static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  const cudaError_t err = grid_slots<LOG_M, kAcf>(smem, device, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (F + G::FT - 1) / G::FT;
  const long long total = static_cast<long long>(B) * tiles;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(total < slots ? total : slots);
  mel_fused_acf_kernel<LOG_M><<<grid, G::NT, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), out, hop, F, lo, 1 + hi - lo, pad, mode,
      tiles, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

// info = {threads per block, frames per tile, dynamic shared memory per
// block, resident blocks per SM}
template <int LOG_M, int ENTRY>
int geometry_m(int hop, int device, int* info) {
  using G = GeometryOf<LOG_M, ENTRY>;
  const size_t smem = smem_of<LOG_M, ENTRY>(hop);
  info[0] = G::NT;
  info[1] = G::FT;
  info[2] = static_cast<int>(smem);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = open_smem<LOG_M, ENTRY>(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kernel_of<LOG_M, ENTRY>(), G::NT,
                                                        smem);
  return static_cast<int>(err);
}

}  // namespace

// The dense entry: out (B, n_cols, F) = |rDFT(win * frame)|^power @ W, 3xTF32
extern "C" int mel_fused_launch(const float* y, long long L, const float* win,
                                const float* tw, const float* W, float* out,
                                int B, int n_fft, int hop, int F, int n_cols,
                                int pad, int mode, int power, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
#define MAPT_CASE(LM)                                                                           \
  case LM:                                                                                      \
    return launch_m<LM>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    MAPT_K1_LOG_MS(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fast entry: the same, the contraction as bf16x3 over the blocks of
// the plan
extern "C" int mel_fused_fast_launch(const float* y, long long L, const float* win,
                                     const float* tw, const int* plan, float* out, int B,
                                     int n_fft, int hop, int F, int n_cols, int blocks, int pad,
                                     int mode, int power, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
#define MAPT_CASE(LM)                                                                        \
  case LM:                                                                                   \
    return fast_launch_m<LM>(y, L, win, tw, plan, out, B, hop, F, n_cols, blocks, pad, mode, \
                             power, device, s);
    MAPT_K1_LOG_MS(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The full-range plan of W (n_bins, n_cols) at strides (s_bin, s_col) into
// plan, plan_w_offset(n_mt) + 256 n_mt ksteps words, for the fast entry and
// K1m (csrc/mel_fused_mixed.cu)
extern "C" int mel_fused_pack_launch(const float* W, long long s_bin, long long s_col, int n_bins,
                                     int n_cols, int* plan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bins < 1 || n_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_mt = (n_cols + 15) / 16, ksteps = (n_bins + 15) / 16;
  const auto s = static_cast<cudaStream_t>(stream);
  mel_fused_fast_pack_kernel<<<(64 * n_mt * ksteps + 255) / 256, 256, 0, s>>>(
      W, s_bin, s_col, n_bins, n_cols, n_mt, ksteps, plan);
  return static_cast<int>(cudaGetLastError());
}

// The ACF entry: out (B, 1 + hi - lo, F) = lag 0 and lags [lo, hi) of
// irfft(|rDFT(win * frame)|^2) of each frame
extern "C" int mel_fused_acf_launch(const float* y, long long L, const float* win,
                                    const float* tw, float* out, int B, int n_fft, int hop,
                                    int F, int lo, int hi, int pad, int mode, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
#define MAPT_CASE(LM) \
  case LM: return acf_launch_m<LM>(y, L, win, tw, out, B, hop, F, lo, hi, pad, mode, device, s);
    MAPT_K1_LOG_MS(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// entry: 0 the dense entry's instance, 1 the ACF entry's, 2 the fast entry's
extern "C" int mel_fused_geometry(int n_fft, int hop, int entry, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
#define MAPT_CASE(LM)                                                   \
  case LM:                                                              \
    return entry == kAcf    ? geometry_m<LM, kAcf>(hop, device, info)   \
           : entry == kFast ? geometry_m<LM, kFast>(hop, device, info)  \
                            : geometry_m<LM, kDense>(hop, device, info);
    MAPT_K1_LOG_MS(MAPT_CASE)
#undef MAPT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
