// Shared device code of the port's FFT kernels (K1 mel_fused, K2 stft, K3
// istft_fused): padded signal reads, the register-resident forward FFT
// (below), and the real-input pack that turns an inverse real FFT into that
// forward FFT (irfft_pack).
//
// Real FFT of N points (N a power of two) through one complex FFT of
// M = N/2 points: z[n] = x[2n] + i*x[2n+1], Z = FFT_M(z), then
//   X[k] = E[k] + W_N^k O[k],  E[k] = (Z[k] + conj Z[M-k]) / 2,
//                              O[k] = (Z[k] - conj Z[M-k]) / (2i).
// The inverse runs the same identities backwards. All arithmetic is FP32;
// twiddles come from a host table (`kernels/dft.py::rfft_twiddles`,
// tw[k] = exp(-2*pi*i*k/N) for k = 0..N/2, built in float64), so no kernel
// evaluates a transcendental. Build without --use_fast_math.
#pragma once

#include <cuda_runtime.h>

namespace mapt {

// y[i] of one clip with NumPy padding semantics outside [0, L).
// mode: 0 constant (zeros), 1 reflect (period 2(L-1)), 2 edge.
static __device__ __forceinline__ float padded_sample(
    const float* __restrict__ y, long long L, long long i, int mode) {
  if (i >= 0 && i < L) return y[i];
  if (mode == 0 || L == 0) return 0.f;
  if (mode == 2) return y[i < 0 ? 0 : L - 1];
  if (L == 1) return y[0];
  const long long period = 2 * (L - 1);
  long long m = i % period;
  if (m < 0) m += period;
  return y[m < L ? m : period - m];
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// The input of the forward FFT that computes an inverse real FFT of N = 2M
// points, from the bins x = X[k], y = X[M-k] and w = W_N^k. The frame's
// packed points z[n] = x[2n] + i*x[2n+1] are z = IFFT_M(Z) with
//   Z[k] = E[k] + i O[k],  E = (X[k] + conj X[M-k]) / 2,
//                          O = (X[k] - conj X[M-k]) W_N^{-k} / 2,
// and IFFT_M(Z) = conj(FFT_M(conj Z)) / M, so the forward passes run on
// Y = conj(Z) / M and z = conj(FFT_M(Y)). Z[M-k] = conj E[k] + i conj O[k],
// so one pair of bins gives both Y[k] (yk) and Y[M-k] (ymk). scale is
// 1 / (2M), exact. The caller zeroes the imaginary parts of X[0] and X[M]
// (irfft semantics).
static __device__ __forceinline__ void irfft_pack(float2 x, float2 y, float2 w, float scale,
                                                  float2& yk, float2& ymk) {
  const float er = (x.x + y.x) * scale, ei = (x.y - y.y) * scale;
  const float dr = (x.x - y.x) * scale, di = (x.y + y.y) * scale;
  const float orr = dr * w.x + di * w.y, oi = di * w.x - dr * w.y;  // O = D conj(w)
  yk = make_float2(er - oi, -ei - orr);
  ymk = make_float2(er + oi, ei - orr);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
static inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Register-resident forward FFT (K1 and K2; K3 runs it on irfft_pack's Y).
//
// The complex FFT of M = 2^log_m points runs as a few in-place
// decimation-in-frequency passes. A group of T = M / kRegPoints threads owns
// one frame; each thread holds kRegPoints points in registers, and a pass of
// radix R = 2^b does kRegPoints / R radix-R butterflies per thread in
// registers (compile-time W_16 constants). Pass p reads its points at
// stride S_p = M >> (bits of passes 0..p), transforms them, multiplies output
// q of butterfly i by W_{R*S_p}^{i*q} (per-pass tables staged from the
// float64-built host table, stage_twiddles) and writes them back to the
// positions it read: each exchange between passes is one write, one
// barrier of the threads that own the frame, one read. The first pass reads
// the windowed frame straight from the staged signal segment, so nothing is
// scattered; the transform ends in mixed-radix digit-reversed order, which
// the emit undoes in its read index (rdigit_rev).
// tests/test_torch_port_stft_plan.py models these index maps in NumPy.
//
// Frame buffer layout: point p of a frame at rpidx(p) = p + p/16 (one float2
// of padding per 16 points), frames rframe_stride(M) apart (an odd number of
// float2, so the emit's reads of 16 frames fall on distinct banks).
constexpr int kRegBits = 4;
constexpr int kRegPoints = 1 << kRegBits;

static __host__ __device__ constexpr int plan_passes(int log_m) {
  return (log_m + kRegBits - 1) / kRegBits;
}

// radix bits of pass p: the log_m bits spread as evenly as the passes allow,
// larger radices last (log_m 10: 3, 3, 4). The last pass has stride 1 and
// no twiddles, so the pass that holds all 16 of a thread's points at once
// loads no twiddle beside them (64 registers, no spill, at n_fft 2048).
static __host__ __device__ constexpr int plan_bits(int log_m, int p) {
  return log_m / plan_passes(log_m) +
         (p >= plan_passes(log_m) - log_m % plan_passes(log_m) ? 1 : 0);
}

// bits consumed by passes 0..p: pass p's stride is M >> plan_shift(log_m, p)
static __host__ __device__ constexpr int plan_shift(int log_m, int p) {
  int s = 0;
  for (int q = 0; q <= p; ++q) s += plan_bits(log_m, q);
  return s;
}

static __host__ __device__ constexpr int brev_bits(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

static __host__ __device__ __forceinline__ int rpidx(int p) { return p + (p >> 4); }

static __host__ __device__ constexpr int rframe_stride(int m) { return m + (m >> 4) + 1; }

// exp(-2*pi*i*j/16), j in [0, 8): the in-radix constants, float64 values
// rounded once to float
static __device__ __forceinline__ float2 w16(int j) {
  constexpr float c1 = 0.92387953251128674f, c2 = 0.70710678118654752f,
                  c3 = 0.38268343236508977f;
  switch (j) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(c1, -c3);
    case 2: return make_float2(c2, -c2);
    case 3: return make_float2(c3, -c1);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-c3, -c1);
    case 6: return make_float2(-c2, -c2);
    default: return make_float2(-c1, -c3);
  }
}

// In-register DFT of the R = 2^B <= 16 points v[O .. O+R-1], natural order
// in and out: a radix-2 DIF network (stage ST pairs points h = R >> (ST+1)
// apart, W_{2h}^j = W_16^{j*8/h}), then a bit-reversal. The network, the
// reversal and every other walk over a thread's points below are template
// recursions, so each index into v is a compile-time constant and v stays
// in registers (a rolled loop would put it in local memory).
template <int B, int O, int ST = 0, int X = 0>
static __device__ __forceinline__ void dif_network(float2 (&v)[kRegPoints]) {
  constexpr int R = 1 << B;
  if constexpr (ST < B && X < R / 2) {
    constexpr int h = R >> (ST + 1);
    constexpr int j = X & (h - 1);
    constexpr int lo = O + 2 * (X - j) + j;  // block X / h of 2h points, offset j
    constexpr int e = j * (8 >> (B - 1 - ST));
    const float2 a = v[lo], b = v[lo + h];
    const float2 d = csub(a, b);
    v[lo] = cadd(a, b);
    if constexpr (e == 0)
      v[lo + h] = d;
    else if constexpr (e == 4)
      v[lo + h] = make_float2(d.y, -d.x);
    else
      v[lo + h] = cmul(d, w16(e));
    dif_network<B, O, ST, X + 1>(v);
  } else if constexpr (ST + 1 < B) {
    dif_network<B, O, ST + 1, 0>(v);
  }
}

template <int B, int O, int Q = 0>
static __device__ __forceinline__ void brev_copy(float2 (&v)[kRegPoints], const float2 (&t)[1 << B]) {
  if constexpr (Q < (1 << B)) {
    constexpr int src = brev_bits(Q, B);
    v[O + Q] = t[src];
    brev_copy<B, O, Q + 1>(v, t);
  }
}

template <int B, int O, int Q = 0>
static __device__ __forceinline__ void take(float2 (&t)[1 << B], const float2 (&v)[kRegPoints]) {
  if constexpr (Q < (1 << B)) {
    t[Q] = v[O + Q];
    take<B, O, Q + 1>(t, v);
  }
}

template <int B, int O>
static __device__ __forceinline__ void dft_regs(float2 (&v)[kRegPoints]) {
  dif_network<B, O>(v);
  float2 t[1 << B];
  take<B, O>(t, v);
  brev_copy<B, O>(v, t);
}

// W_M^j for 0 <= j < M from the host table tw[e] = W_N^e, e = 0..M (N = 2M):
// W_M^j = W_N^{2j}, and W_N^e = -W_N^{e-M} past the half circle (exact)
static __device__ __forceinline__ float2 w_m_from_host(const float2* __restrict__ tw, int j,
                                                       int m) {
  const int e = 2 * j;
  if (e <= m) return tw[e];
  const float2 w = tw[e - m];
  return make_float2(-w.x, -w.y);
}

// Position of point r of the c-th butterfly of thread t in pass PASS:
// butterfly u = t + c*T, block u / S, offset i = u % S, point r at stride S
template <int LOG_M, int PASS>
static __device__ __forceinline__ int rpass_pos(int t, int c, int r) {
  constexpr int LOG_S = LOG_M - plan_shift(LOG_M, PASS);
  constexpr int T = (1 << LOG_M) >> kRegBits;
  const int u = t + c * T;
  return ((u >> LOG_S) << (LOG_S + plan_bits(LOG_M, PASS))) + (u & ((1 << LOG_S) - 1)) +
         (r << LOG_S);
}

// rpidx(rpass_pos(t, c, r)): where the stride is a multiple of 16 the
// padding of point r is a constant offset from point 0's
template <int LOG_M, int PASS>
static __device__ __forceinline__ int rpass_addr(int t, int c, int r) {
  constexpr int S = 1 << (LOG_M - plan_shift(LOG_M, PASS));
  if constexpr (S % 16 == 0)
    return rpidx(rpass_pos<LOG_M, PASS>(t, c, 0)) + r * (S + S / 16);
  else
    return rpidx(rpass_pos<LOG_M, PASS>(t, c, r));
}

// The twiddles of pass p, W_{R*S}^{i*q} = W_M^{i*q*M/(R*S)} for q = 1..R-1
// and i < S, staged as table[(q-1)*S + i] at offset rtw_offset(log_m, p) of
// one shared array (fewer than M entries in all): lanes with consecutive i
// read consecutive words, so the reads are free of bank conflicts
static __host__ __device__ constexpr int rtw_size(int log_m, int p) {
  return ((1 << plan_bits(log_m, p)) - 1) * ((1 << log_m) >> plan_shift(log_m, p));
}

static __host__ __device__ constexpr int rtw_offset(int log_m, int p) {
  int o = 0;
  for (int q = 0; q < p; ++q) o += rtw_size(log_m, q);
  return o;
}

// Stage the tables of passes PASS.. from the host table (threads tid of nt)
template <int LOG_M, int PASS = 0>
static __device__ __forceinline__ void stage_twiddles(float2* twp,
                                                      const float2* __restrict__ tw_host,
                                                      int tid, int nt) {
  if constexpr (PASS < plan_passes(LOG_M)) {
    constexpr int M = 1 << LOG_M;
    constexpr int LOG_S = LOG_M - plan_shift(LOG_M, PASS);
    constexpr int STEP = M >> (LOG_S + plan_bits(LOG_M, PASS));
    float2* table = twp + rtw_offset(LOG_M, PASS);
    for (int x = tid; x < rtw_size(LOG_M, PASS); x += nt)
      table[x] = w_m_from_host(tw_host, (x & ((1 << LOG_S) - 1)) * ((x >> LOG_S) + 1) * STEP, M);
    stage_twiddles<LOG_M, PASS + 1>(twp, tw_host, tid, nt);
  }
}

// v[O + q] *= table[(q-1)*S + i] for q = Q .. R-1
template <int S, int O, int Q, int R>
static __device__ __forceinline__ void rtwiddle(float2 (&v)[kRegPoints], const float2* table,
                                                int i) {
  if constexpr (Q < R) {
    v[O + Q] = cmul(v[O + Q], table[(Q - 1) * S + i]);
    rtwiddle<S, O, Q + 1, R>(v, table, i);
  }
}

// Butterfly C of pass PASS on the thread's registers v[C*R .. C*R+R-1]:
// the radix-R DFT, then output q times W_{R*S}^{i*q}. Every pass has radix
// 8 or 16 (plan_bits >= 3 for log_m >= 6), so a thread does one or two
// butterflies per pass, and each is a separate force-inlined instance:
// register arrays indexed with template constants stay in registers.
template <int LOG_M, int PASS, int C>
static __device__ __forceinline__ void rbutterfly(float2 (&v)[kRegPoints], const float2* twp,
                                                  int t) {
  constexpr int M = 1 << LOG_M;
  constexpr int R = 1 << plan_bits(LOG_M, PASS);
  constexpr int S = M >> plan_shift(LOG_M, PASS);
  constexpr int T = M >> kRegBits;
  static_assert(R == 8 || R == 16, "passes are radix 8 or 16");
  dft_regs<plan_bits(LOG_M, PASS), C * R>(v);
  if constexpr (S > 1)
    rtwiddle<S, C * R, 1, R>(v, twp + rtw_offset(LOG_M, PASS), (t + C * T) & (S - 1));
}

// Load (STORE false) or store the points of butterfly C of pass PASS
// between the thread's registers and the frame at fb
template <int LOG_M, int PASS, int C, bool STORE, int RI = 0>
static __device__ __forceinline__ void rmove(float2 (&v)[kRegPoints], float2* fb, int t) {
  constexpr int R = 1 << plan_bits(LOG_M, PASS);
  if constexpr (RI < R) {
    float2& x = fb[rpass_addr<LOG_M, PASS>(t, C, RI)];
    if constexpr (STORE)
      x = v[C * R + RI];
    else
      v[C * R + RI] = x;
    rmove<LOG_M, PASS, C, STORE, RI + 1>(v, fb, t);
  }
}

// The points r = 0..R-1 of pass 0's butterfly u, v[O + r], into the frame
// buffer fb at positions u + r*S0 (a first pass that owns other
// butterflies than rpass_pos gives a thread: K3's and K1's ACF entry's)
template <int S0, int R, int O>
static __device__ __forceinline__ void store_butterfly(const float2 (&v)[kRegPoints], float2* fb,
                                                       int u) {
#pragma unroll
  for (int r = 0; r < R; ++r) fb[rpidx(u + r * S0)] = v[O + r];
}

// Barrier of one group of GT threads that owns whole frames: named barrier
// 1 + g (0 is __syncthreads'), or the whole block when GT is 0. The passes
// of a frame exchange points only among its own threads, so groups run
// their passes without waiting for each other.
template <int GT>
static __device__ __forceinline__ void group_sync(int g) {
  if constexpr (GT == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(GT) : "memory");
}

// Passes PASS.. of the frame at fb (frame buffer layout above); each reads
// what the previous pass wrote, behind a group barrier; the last pass ends
// without one. A butterfly is loaded, transformed and stored before the
// next one is loaded (its points are its own in this pass), so one
// butterfly's points are live at a time.
template <int LOG_M, int PASS, int C>
static __device__ __forceinline__ void rstep(float2 (&v)[kRegPoints], float2* fb,
                                             const float2* twp, int t) {
  rmove<LOG_M, PASS, C, false>(v, fb, t);
  rbutterfly<LOG_M, PASS, C>(v, twp, t);
  rmove<LOG_M, PASS, C, true>(v, fb, t);
}

template <int LOG_M, int PASS, int GT>
static __device__ __forceinline__ void rexchange_passes(float2* fb, float2 (&v)[kRegPoints],
                                                        const float2* twp, int t, int g) {
  if constexpr (PASS < plan_passes(LOG_M)) {
    group_sync<GT>(g);
    rstep<LOG_M, PASS, 0>(v, fb, twp, t);
    if constexpr (plan_bits(LOG_M, PASS) < kRegBits) rstep<LOG_M, PASS, 1>(v, fb, twp, t);
    rexchange_passes<LOG_M, PASS + 1, GT>(fb, v, twp, t, g);
  }
}

// Where bin k (0 <= k < M) of the transform sits after the last pass: its
// mixed-radix digits, least significant first, are the passes' output
// indices q_p, and q_p sits at stride S_p. All radices are powers of two,
// so this is a permutation of k's bits: rdigit_rev(a + b) =
// rdigit_rev(a) + rdigit_rev(b) when a and b share no bit.
static __host__ __device__ constexpr int rdigit_rev(int log_m, int k) {
  int p = 0;
  for (int j = 0; j < plan_passes(log_m); ++j) {
    p += (k & ((1 << plan_bits(log_m, j)) - 1)) << (log_m - plan_shift(log_m, j));
    k >>= plan_bits(log_m, j);
  }
  return p;
}

// Asynchronous copies from device to shared memory (cp.async, sm_80+)
static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage samples s0 .. s0+len-1 of the clip yb (length L, NumPy padding
// outside it) in seg; return the offset in seg at which sample s0 sits.
// A segment inside the clip goes by cp.async: a 16-byte-aligned body and
// scalar head and tail, the shared copy shifted so that both sides share
// their alignment (seg must hold len + 3 floats). A segment that touches
// the clip's edges is staged with plain loads through padded_sample. The
// caller makes the copy visible: cp_async_wait_all(), then a barrier.
static __device__ __forceinline__ int stage_segment(const float* __restrict__ yb, long long L,
                                                    long long s0, int len, int mode,
                                                    float* seg, int tid, int nt) {
  if (s0 < 0 || s0 + len > L) {
    for (int i = tid; i < len; i += nt) seg[i] = padded_sample(yb, L, s0 + i, mode);
    return 0;
  }
  const float* g = yb + s0;
  const int mis = static_cast<int>((reinterpret_cast<size_t>(g) >> 2) & 3);  // floats past 16 B
  const int head = (4 - mis) & 3;
  const int n16 = (len - head) >> 2;
  const int tail = len - head - 4 * n16;
  float* d = seg + mis;
  if (tid < head) cp_async4(d + tid, g + tid);
  for (int i = tid; i < n16; i += nt) cp_async16(d + head + 4 * i, g + head + 4 * i);
  if (tid < tail) cp_async4(d + head + 4 * n16 + tid, g + head + 4 * n16 + tid);
  cp_async_commit();
  return mis;
}

// The tile geometry of K1 and K2 at M = 2^LOG_M complex points, and its
// shared memory: a block holds FT frame buffers, the passes' twiddle
// tables and the signal segment of its FT frames.
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxThreads = 1024;

// At most 1024 threads a block (64 registers each for one block per SM);
// from n_fft 4096 on, 512 (the magnitude emit needs more than 64 registers)
static __host__ __device__ constexpr int max_threads(int log_m) {
  return log_m >= 11 ? kMaxThreads / 2 : kMaxThreads;
}

// MAX_NT_: a kernel's own cap on its threads (K1's fast entry takes 512, so
// that two blocks share an SM)
template <int LOG_M, int MAX_NT_ = max_threads(LOG_M)>
struct Geometry {
  static constexpr int M = 1 << LOG_M;
  static constexpr int T = M >> kRegBits;  // threads per frame
  static constexpr int MAX_NT = MAX_NT_;
  static constexpr int FT = (MAX_NT / T) < 16 ? (MAX_NT / T) : 16;  // frames per tile
  static constexpr int LOG_FT = FT == 16 ? 4 : FT == 8 ? 3 : FT == 4 ? 2 : FT == 2 ? 1 : 0;
  static constexpr int NT = FT * T;  // threads per block
  // threads of a barrier group between passes: whole frames, at most 128
  // threads where a frame allows (so at most 8 named barriers); 0 when the
  // group is the block
  static constexpr int GT_ = T > (NT < 128 ? NT : 128) ? T : (NT < 128 ? NT : 128);
  static constexpr int GT = GT_ == NT ? 0 : GT_;
  static constexpr int FS = rframe_stride(M);
  // frame buffers, then the passes' twiddle tables (room for M entries; M
  // is even, so the segment after it starts 16-byte aligned)
  static constexpr int TW_OFF = FT * FS;
  static constexpr int SEG_OFF_BYTES = 8 * ((TW_OFF + M + 1) & ~1);
  static __host__ __device__ size_t smem(int hop) {
    const int seg_cap = ((FT - 1) * hop + 2 * M + 3 + 3) & ~3;
    return SEG_OFF_BYTES + sizeof(float) * static_cast<size_t>(seg_cap);
  }
};

// Pass 0's points of butterfly C, packed and windowed, from the frame at fr
// in the staged segment (PAIRS: fr is 8-byte aligned, read float2s)
template <int LOG_M, int C, bool PAIRS, int RI = 0>
static __device__ __forceinline__ void load_frame(float2 (&v)[kRegPoints], const float* fr,
                                                  const float2* __restrict__ win2, int t) {
  constexpr int R0 = 1 << plan_bits(LOG_M, 0);
  if constexpr (RI < R0) {
    const int n = rpass_pos<LOG_M, 0>(t, C, RI);
    const float2 w = __ldg(win2 + n);
    const float2 x = PAIRS ? reinterpret_cast<const float2*>(fr)[n]
                           : make_float2(fr[2 * n], fr[2 * n + 1]);
    v[C * R0 + RI] = make_float2(w.x * x.x, w.y * x.y);
    load_frame<LOG_M, C, PAIRS, RI + 1>(v, fr, win2, t);
  }
}

// Pass 0 of the frame, one butterfly at a time: segment -> registers ->
// the frame buffer at fb
template <int LOG_M, bool PAIRS>
static __device__ __forceinline__ void first_pass(float2 (&v)[kRegPoints], const float* fr,
                                                  const float2* __restrict__ win2, float2* fb,
                                                  const float2* twp, int t) {
  load_frame<LOG_M, 0, PAIRS>(v, fr, win2, t);
  rbutterfly<LOG_M, 0, 0>(v, twp, t);
  rmove<LOG_M, 0, 0, true>(v, fb, t);
  if constexpr (plan_bits(LOG_M, 0) < kRegBits) {
    load_frame<LOG_M, 1, PAIRS>(v, fr, win2, t);
    rbutterfly<LOG_M, 0, 1>(v, twp, t);
    rmove<LOG_M, 0, 1, true>(v, fb, t);
  }
}

// ---------------------------------------------------------------------------
// Mixed-radix passes (K1's mixed-radix entry, csrc/mel_fused_mixed.cu): the
// complex FFT of M = 2^a * 5^b points as in-place decimation-in-frequency
// passes, the radix-5 passes first, then the power of two in radix-8
// passes, the first of which takes what is left (radix 2 or 4): M = 200 is
// 5, 5, 8. Pass p reads its points at stride S_p = M / (R_0 ... R_p),
// transforms them (natural order in and out) and multiplies output q of the
// butterfly at offset i < S_p by W_{R_p S_p}^{i q}; after the last pass bin
// k = q_0 + R_0 q_1 + R_0 R_1 q_2 + ... sits at q_0 S_0 + q_1 S_1 + ...
// (mixed_pos). kernels/mel_fused.py::mixed_fft runs the same passes in torch.
static __host__ __device__ constexpr int mixed_fives(int m) {
  int b = 0;
  while (m % 5 == 0) {
    m /= 5;
    ++b;
  }
  return b;
}

static __host__ __device__ constexpr int mixed_log2(int m) {
  while (m % 5 == 0) m /= 5;
  int l = 0;
  while (m > 1) {
    m >>= 1;
    ++l;
  }
  return l;
}

static __host__ __device__ constexpr int mixed_passes(int m) {
  return mixed_fives(m) + (mixed_log2(m) + 2) / 3;
}

static __host__ __device__ constexpr int mixed_radix(int m, int p) {
  return p < mixed_fives(m)    ? 5
         : p > mixed_fives(m) ? 8
                              : 1 << (mixed_log2(m) - 3 * ((mixed_log2(m) + 2) / 3 - 1));
}

static __host__ __device__ constexpr int mixed_stride(int m, int p) {
  int s = m;
  for (int q = 0; q <= p; ++q) s /= mixed_radix(m, q);
  return s;
}

static __host__ __device__ constexpr int mixed_pos(int m, int k) {
  int pos = 0;
  for (int p = 0; p < mixed_passes(m); ++p) {
    pos += (k % mixed_radix(m, p)) * mixed_stride(m, p);
    k /= mixed_radix(m, p);
  }
  return pos;
}

// The twiddles of pass p, W_{R S}^{i q} for q = 1..R-1 and i < S, staged as
// table[(q-1)*S + i] at offset mixed_tw_offset(m, p) (none for the last
// pass, whose stride is 1)
static __host__ __device__ constexpr int mixed_tw_size(int m, int p) {
  return mixed_stride(m, p) > 1 ? (mixed_radix(m, p) - 1) * mixed_stride(m, p) : 0;
}

static __host__ __device__ constexpr int mixed_tw_offset(int m, int p) {
  int o = 0;
  for (int q = 0; q < p; ++q) o += mixed_tw_size(m, q);
  return o;
}

// Stage every pass's table from the host table tw_host (W_N^e, e = 0..M)
// (threads tid of nt)
template <int M>
static __device__ __forceinline__ void stage_mixed_twiddles(float2* twp,
                                                            const float2* __restrict__ tw_host,
                                                            int tid, int nt) {
  constexpr int P = mixed_passes(M);
  for (int x = tid; x < mixed_tw_offset(M, P); x += nt) {
    int p = 0;
    while (x >= mixed_tw_offset(M, p + 1)) ++p;
    const int s = mixed_stride(M, p), e = x - mixed_tw_offset(M, p);
    twp[x] = w_m_from_host(tw_host, (e % s) * (e / s + 1) * (M / (mixed_radix(M, p) * s)), M);
  }
}

// In-register DFT of the 5 points v[O .. O+4], natural order in and out
// (cos and sin of 2 pi / 5 and 4 pi / 5, float64 values rounded once)
template <int O>
static __device__ __forceinline__ void dft5(float2 (&v)[kRegPoints]) {
  constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f,
                  s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;
  const float2 x0 = v[O];
  const float2 t1 = cadd(v[O + 1], v[O + 4]), t2 = cadd(v[O + 2], v[O + 3]);
  const float2 t3 = csub(v[O + 1], v[O + 4]), t4 = csub(v[O + 2], v[O + 3]);
  const float2 a1 = make_float2(x0.x + c1 * t1.x + c2 * t2.x, x0.y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(x0.x + c2 * t1.x + c1 * t2.x, x0.y + c2 * t1.y + c1 * t2.y);
  const float2 b1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
  const float2 b2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
  v[O] = cadd(x0, cadd(t1, t2));
  v[O + 1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
  v[O + 4] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
  v[O + 2] = make_float2(a2.x + b2.y, a2.y - b2.x);  // a2 - i b2
  v[O + 3] = make_float2(a2.x - b2.y, a2.y + b2.x);  // a2 + i b2
}

// The radix-R DFT of a mixed pass on v[O .. O+R-1]
template <int R, int O>
static __device__ __forceinline__ void mixed_dft(float2 (&v)[kRegPoints]) {
  static_assert(R == 2 || R == 4 || R == 5 || R == 8, "mixed passes are radix 2, 4, 5 or 8");
  if constexpr (R == 5)
    dft5<O>(v);
  else
    dft_regs<R == 8 ? 3 : R == 4 ? 2 : 1, O>(v);
}

// Outputs q = 1..R-1 of the butterfly at offset i of pass P times the
// pass's twiddles
template <int M, int P>
static __device__ __forceinline__ void mixed_twiddle(float2 (&v)[kRegPoints], const float2* twp,
                                                     int i) {
  constexpr int R = mixed_radix(M, P), S = mixed_stride(M, P);
  if constexpr (S > 1) {
    const float2* t = twp + mixed_tw_offset(M, P) + i;
#pragma unroll
    for (int q = 1; q < R; ++q) v[q] = cmul(v[q], t[(q - 1) * S]);
  }
}

}  // namespace mapt
