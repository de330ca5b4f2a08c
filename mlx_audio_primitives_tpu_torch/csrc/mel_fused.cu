// K1: fused filterbank spectrogram, |rFFT(window * frame)|^p @ W.
//
// Replaces mlx_audio_primitives_tpu/kernels/mel_fused.py::melspectrogram_pallas
// (pallas_call in _mel_radix_core). W is any dense (n_bins, n_cols) matrix
// (mel, MFCC's mel, a centroid's [1, f] moments, chroma, a lag basis); mel
// sparsity is not used. Frames, spectra and power rows never reach device
// memory, and the output is written as (B, n_cols, F).
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
#include <cstdint>

#include "fft_common.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kRounds = 4;  // rounds of power rows per tile (FT of them where FT < 4)

// Float offset of frame f's power row in the frame buffers: hi parts at
// [0, M], lo parts at [M+1, 2M+1]. Rows of 8 consecutive frames start on
// banks 4 apart, so a B fragment load (8 frames x 4 bins) hits 32 banks;
// frame buffers too small for the shift (M < 256) keep it at 0.
template <int LOG_M>
__device__ __forceinline__ int row_offset(int f) {
  constexpr int M = 1 << LOG_M;
  constexpr int FSW = 2 * mapt::rframe_stride(M);  // floats per frame buffer
  if constexpr (FSW - 2 * (M + 1) >= 31)
    return f * FSW + ((4 * f - f * FSW) & 31);
  else
    return f * FSW;
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

// row[k] = hi, row[M+1+k] = lo of p
template <int LOG_M>
__device__ __forceinline__ void put_split(float* row, int k, float p) {
  const unsigned hi = tf32_rna(p);
  row[k] = __uint_as_float(hi);
  row[(1 << LOG_M) + 1 + k] = __uint_as_float(tf32_rna(p - __uint_as_float(hi)));
}

// The power row in natural bin order from the thread's scratch slots: bins
// k and M-k of each pair (bin M/2 once, bins 0 and M from k = 0)
template <int LOG_M, int TP, int NT, int J = 0>
__device__ __forceinline__ void write_pairs(float* row, const float* scratch, int me, int k0) {
  constexpr int M = 1 << LOG_M;
  if constexpr (J * TP <= M / 2) {
    const int k = k0 + J * TP;
    if (k <= M / 2) {
      put_split<LOG_M>(row, k, scratch[2 * J * NT + me]);
      if constexpr (J * TP < M / 2) put_split<LOG_M>(row, M - k, scratch[(2 * J + 1) * NT + me]);
    }
    write_pairs<LOG_M, TP, NT, J + 1>(row, scratch, me, k0);
  }
}

// One round of power rows: frames f0r + (me mod FR) of the tile, TP =
// NT/FR threads per frame, frames fastest across lanes (as K2's emit);
// every read of the round's spectra ends at a barrier before the first
// write lands in their buffers. The thread index is read afresh on each
// side of the barrier, so no address is held through it.
template <int LOG_M, int FR, int NT>
__device__ __forceinline__ void power_round(float2* buf, float* rows, float* scratch,
                                            const float2* __restrict__ tw_g, int f0r, int tid,
                                            bool mag) {
  constexpr int FS = mapt::rframe_stride(1 << LOG_M), TP = NT / FR;
  {
    const int me = opaque(tid), f = f0r + (me & (FR - 1)), k0 = me / FR;
    power_pairs<LOG_M, TP, NT>(buf + f * FS, tw_g, scratch, me, k0,
                               mapt::rdigit_rev(LOG_M, k0),
                               k0 ? mapt::rdigit_rev(LOG_M, TP - k0) : 0, mag);
  }
  __syncthreads();
  const int me = opaque(tid), f = f0r + (me & (FR - 1));
  write_pairs<LOG_M, TP, NT>(rows + row_offset<LOG_M>(f), scratch, me, me / FR);
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
  constexpr int KSTEPS = (M + 1 + 7) / 8;     // k-steps of 8 bins over n_bins = M + 1
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
        power_round<LOG_M, FT / R, NT>(buf, rows, seg, tw_g, r * (FT / R), tid, mag);
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
      float a[4];
      load_a(a, W, M + 1, n_cols_, ks, ca, q);
      for (int kk = ks; kk < KSTEPS; kk += n_ks_) {
        float an[4];
        load_a(an, W, M + 1, n_cols_, kk + n_ks_, ca, q);  // zeros past the last step
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

// Open the instance of LOG_M to the whole 227 KB once per device; the
// blocks a launch keeps resident follow from the shared memory it asks for.
template <int LOG_M>
cudaError_t open_smem(int device) {
  static bool opened[kMaxDevices];
  if (opened[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      mel_fused_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, mapt::kSmemLimit);
  opened[device] = err == cudaSuccess;
  return err;
}

// Per device: the grid of the last shared-memory size launched (SMs times
// resident blocks), so the occupancy query runs once per size, not per call
template <int LOG_M>
int launch_m(const float* y, long long L, const float* win, const float* tw, const float* W,
             float* out, int B, int hop, int F, int n_cols, int pad, int mode, int power,
             int device, cudaStream_t stream) {
  using G = mapt::Geometry<LOG_M>;
  static size_t sized[kMaxDevices];
  static int slots[kMaxDevices];
  const size_t smem = G::smem(hop);
  // the power rows' scratch takes the segment buffer of the least hop the
  // radix gate admits (n_fft/hop <= 8, hop >= 128)
  if (smem > mapt::kSmemLimit || 8 * hop < 2 * G::M || hop < 128 || device < 0 ||
      device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (sized[device] != smem) {
    int per_sm = 0, sms = 0;
    cudaError_t err = open_smem<LOG_M>(device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_fused_kernel<LOG_M>,
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
  if (total <= 0 || n_cols <= 0) return static_cast<int>(cudaSuccess);
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(total < slots[device] ? total : slots[device]);
  // m-tiles of 16 columns; k-slices per m-tile to fill the block's warps
  const int n_mt = (n_cols + 15) / 16;
  const int n_ks = G::NT / 32 / n_mt > 1 ? G::NT / 32 / n_mt : 1;
  mel_fused_kernel<LOG_M><<<grid, G::NT, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), W, out, hop, F, n_cols, n_mt, n_ks, pad,
      mode, power, tiles, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

// info = {threads per block, frames per tile, dynamic shared memory per
// block, resident blocks per SM}
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], mel_fused_kernel<LOG_M>,
                                                        G::NT, smem);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int mel_fused_launch(const float* y, long long L, const float* win,
                                const float* tw, const float* W, float* out,
                                int B, int n_fft, int hop, int F, int n_cols,
                                int pad, int mode, int power, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (__builtin_ctz(static_cast<unsigned>(n_fft / 2))) {
    case 6: return launch_m<6>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    case 7: return launch_m<7>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    case 8: return launch_m<8>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    case 9: return launch_m<9>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    case 10: return launch_m<10>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    case 11: return launch_m<11>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    case 12: return launch_m<12>(y, L, win, tw, W, out, B, hop, F, n_cols, pad, mode, power, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mel_fused_geometry(int n_fft, int hop, int device, int* info) {
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
