// K6: the dB conversion, coef * log10(max(S, amin) / ref), with the top_db
// floor against the maximum over the whole input.
//
// Replaces no pallas_call: the JAX package computes it in XLA
// (mlx_audio_primitives_tpu/ops/convert.py::_to_db), and before this kernel
// the port ran it as four to six PyTorch passes over the whole input (clamp,
// divide, log10, scale; with top_db a global max, a scalar subtraction and
// a maximum), each reading and writing the whole tensor.
//
// Each value is computed in float32 with the plain route's operations in its
// order: the clamp returns a NaN as it is (torch.clamp), the division by a
// scalar ref is a multiplication by its float32 reciprocal, as PyTorch's
// CUDA division by a host scalar computes it (1 / ref is formed on the host),
// then log10f (this library is built without fast math, so it is the
// log10f PyTorch's CUDA log10 calls) and the scale. __fmul_rn keeps nvcc
// from contracting a product into an FMA. At ref = 1 the result is bit for
// bit the plain route's, and at any scalar ref the same float32 operations.
//
// The input is any n values in one dense block of memory, in any order:
// every value maps alone and the maximum does not depend on the order, so
// the output, laid out as the input, is written at the same offsets.
//
// The whole grid walks the input together, a float4 a thread a step (single
// floats where S or the output is not 16-byte aligned), the grid's threads
// on neighbouring values; the grid is the input's blocks of 1024 values, at
// most kBlocksPerSm blocks an SM (one resident wave). With top_db, two
// launches on one stream: db_max_kernel computes the dB values and reduces
// their maximum (NaN wins, as in torch.max) to one value a block, in a
// workspace slot; then db_fused_kernel, with the same grid, reduces the
// slots in every block, forms thr = max - top_db, and walks the input from
// its end, where the first launch read last and what it read is the
// likeliest still in the 50 MB L2, recomputing each dB value and writing
// maximum(dB, thr) (a NaN in either operand wins, as in torch.maximum). Its
// loads and stores are streaming (evict first), so that they do not push
// out of L2 the values it has still to read again. Without top_db only
// db_fused_kernel runs, against thr = -inf, which leaves every value as it
// is.
//
// What bounds it on this card: device-memory bytes, one read of S and one
// write of the result (8 bytes a value; with top_db S is read twice, the
// second time partly from L2), against a log10f of some twenty
// instructions a value. The 64 x 30 s, 128-mel log-mel (42.3 MB) takes
// 0.025 ms at 3.35 TB/s. Measured there (NVIDIA H100 80GB HBM3, 700 W), with
// top_db: the two launches 0.0432-0.0433 ms against 0.0440-0.0441 for the
// same two phases in one cooperative launch with a grid barrier; streaming
// loads and stores in the floor pass saved 6%. Variants that kept 70% of
// the input in shared memory across a grid barrier or skipped the max
// pass's log10f where a value cannot hold the maximum read 0.048-0.051 ms.
//
// The per-item form (db_item_launch; Whisper's log-mel, where each clip of a
// batch is floored at its own maximum less top_db, so that a clip's features
// do not depend on its batch-mates): items of rows x cols values, rows a
// stride apart and each row's values neighbours (a [..., :-1] slice of a
// (B, n_mels, F) mel is read in place), and out = v * scale + offset with v
// the floored dB value, written dense (items, rows, cols). Each item's
// values are cut into equal chunks, one a block; db_item_max_kernel reduces
// a chunk's maximum into its slot, and db_item_kernel reduces the slots of
// its item and walks its chunk (the blocks in reverse, so that the items the
// first launch read last come first, where L2 may still hold them), with
// the plain route's operations: scale and offset as a product and a sum,
// each rounded (no FMA).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;

__device__ __forceinline__ float db_value(float s, float amin, float inv, float coef) {
  const float c = isnan(s) ? s : fmaxf(s, amin);
  return __fmul_rn(coef, log10f(__fmul_rn(c, inv)));
}

// torch.max's reduction: a NaN is the maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// torch.maximum: a NaN in either operand is the result, the first one first
__device__ __forceinline__ float floor_at(float d, float thr) {
  return isnan(d) ? d : (isnan(thr) ? thr : fmaxf(d, thr));
}

// V values at p into v; STREAM: the last read of them (evict first)
template <int V, bool STREAM>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 t = STREAM ? __ldcs(q) : *q;
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = STREAM ? __ldcs(p) : *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// The block's maximum of m; valid in every thread of warp 0.
__device__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// The maximum of the dB values, one a block into slot[blockIdx.x]: groups
// of V values from the input's start; the rest, fewer than V values at its
// end, falls to the first threads.
template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
db_max_kernel(const float* __restrict__ s, long long n, float amin, float inv, float coef,
              float* __restrict__ slot) {
  const long long groups = n / V, t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float m = -INFINITY;
  for (long long g = t; g < groups; g += stride) {
    float v[V];
    load_v<V, false>(s + g * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) m = nan_max(m, db_value(v[j], amin, inv, coef));
  }
  if (t < n - groups * V) m = nan_max(m, db_value(s[groups * V + t], amin, inv, coef));
  m = block_max(m);
  if (threadIdx.x == 0) slot[blockIdx.x] = m;
}

// maximum(dB, thr) written to out, the rest first and then the groups from
// the input's end. TOP_DB: thr is the maximum of db_max_kernel's slots (one
// a block of this grid) less top_db; else -inf.
template <int V, bool TOP_DB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
db_fused_kernel(const float* __restrict__ s, float* __restrict__ out, long long n, float amin,
                float inv, float coef, float top_db, const float* __restrict__ slot) {
  float thr = -INFINITY;
  if constexpr (TOP_DB) {
    float m = -INFINITY;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) m = nan_max(m, slot[b]);
    m = block_max(m);
    __shared__ float block_thr;
    if (threadIdx.x == 0) block_thr = __fsub_rn(m, top_db);
    __syncthreads();
    thr = block_thr;
  }
  const long long groups = n / V, t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (t < n - groups * V)
    out[groups * V + t] = floor_at(db_value(s[groups * V + t], amin, inv, coef), thr);
  if (groups == 0) return;
  for (long long g = (groups - 1) / stride * stride + t; g >= 0; g -= stride) {
    if (g >= groups) continue;
    float v[V];
    load_v<V, true>(s + g * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = floor_at(db_value(v[j], amin, inv, coef), thr);
    store_v<V>(out + g * V, v);
  }
}

// The per-item form. Chunk c of bpi of an item of n values: [n c / bpi,
// n (c + 1) / bpi), walked row by row, a row's values four a thread in
// flight; fn(value, its index in the item) for each. Indices within an item
// are 32-bit (the launcher holds an item to INT32_MAX values): at 32
// registers a thread, 64-bit ones spilled.
template <typename Fn>
__device__ __forceinline__ void walk_chunk(int n, int c, int bpi, int cols, long long s_row,
                                           const float* s, bool stream, Fn&& fn) {
  const int e0 = static_cast<int>(static_cast<long long>(n) * c / bpi);
  const int e1 = static_cast<int>(static_cast<long long>(n) * (c + 1) / bpi);
  for (int r = e0 / cols; r < (e1 + cols - 1) / cols; ++r) {
    const int base = r * cols;
    const int c0 = e0 > base ? e0 - base : 0, c1 = e1 - base < cols ? e1 - base : cols;
    const float* row = s + r * s_row;
    int x = c0 + threadIdx.x;
    for (; x + 3 * kThreads < c1; x += 4 * kThreads) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = stream ? __ldcs(row + x + j * kThreads) : row[x + j * kThreads];
#pragma unroll
      for (int j = 0; j < 4; ++j) fn(v[j], base + x + j * kThreads);
    }
    for (; x < c1; x += kThreads) fn(stream ? __ldcs(row + x) : row[x], base + x);
  }
}

// The maximum of the dB values of chunk blockIdx.x % bpi of item
// blockIdx.x / bpi into slot[blockIdx.x]
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
db_item_max_kernel(const float* __restrict__ s, int n, int cols, long long s_item,
                   long long s_row, int bpi, float amin, float inv, float coef,
                   float* __restrict__ slot) {
  const int b = blockIdx.x / bpi;
  float m = -INFINITY;
  walk_chunk(n, blockIdx.x % bpi, bpi, cols, s_row, s + b * s_item, false,
             [&](float v, int) { m = nan_max(m, db_value(v, amin, inv, coef)); });
  m = block_max(m);
  if (threadIdx.x == 0) slot[blockIdx.x] = m;
}

// out = maximum(dB, thr) * scale + offset over the chunk, the blocks from
// the last; TOP_DB: thr is the maximum of the item's bpi slots less top_db,
// else -inf
template <bool TOP_DB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
db_item_kernel(const float* __restrict__ s, float* __restrict__ out, int n, int cols,
               long long s_item, long long s_row, int bpi, float amin, float inv, float coef,
               float top_db, float scale, float offset, const float* __restrict__ slot) {
  const int x = gridDim.x - 1 - blockIdx.x;
  const int b = x / bpi;
  float thr = -INFINITY;
  if constexpr (TOP_DB) {
    float m = -INFINITY;
    for (int i = threadIdx.x; i < bpi; i += kThreads) m = nan_max(m, slot[b * bpi + i]);
    m = block_max(m);
    __shared__ float block_thr;
    if (threadIdx.x == 0) block_thr = __fsub_rn(m, top_db);
    __syncthreads();
    thr = block_thr;
  }
  float* o = out + static_cast<long long>(b) * n;
  walk_chunk(n, x % bpi, bpi, cols, s_row, s + b * s_item, true,
             [&](float v, int at) {
               const float d = floor_at(db_value(v, amin, inv, coef), thr);
               __stcs(o + at, __fadd_rn(__fmul_rn(d, scale), offset));
             });
}

}  // namespace

// The workspace slots a launch on `device` may use (one float each): the
// largest grid, kBlocksPerSm blocks an SM.
extern "C" int db_fused_slots(int device, int* slots) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *slots = sms * kBlocksPerSm;
  return static_cast<int>(err);
}

// K6 over n > 0 values in one dense block at s, the result at the same
// offsets from out: out = coef * log10(max(s, amin) * inv) in one launch;
// with has_top_db, floored at its maximum less top_db: db_max_kernel into
// slot (db_fused_slots() floats on the device, used by no other launch in
// flight), then db_fused_kernel, on the stream.
extern "C" int db_fused_launch(const float* s, float* out, long long n, float amin, float inv,
                               float coef, int has_top_db, float top_db, float* slot, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  err = static_cast<cudaError_t>(db_fused_slots(device, &slots));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec =
      (reinterpret_cast<std::uintptr_t>(s) | reinterpret_cast<std::uintptr_t>(out)) % 16 == 0;
  const long long per_block = 4LL * kThreads;
  const long long blocks = (n + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(blocks < slots ? blocks : slots)), block(kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_top_db) {
    if (vec)
      db_max_kernel<4><<<grid, block, 0, st>>>(s, n, amin, inv, coef, slot);
    else
      db_max_kernel<1><<<grid, block, 0, st>>>(s, n, amin, inv, coef, slot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (vec)
      db_fused_kernel<4, true><<<grid, block, 0, st>>>(s, out, n, amin, inv, coef, top_db, slot);
    else
      db_fused_kernel<1, true><<<grid, block, 0, st>>>(s, out, n, amin, inv, coef, top_db, slot);
  } else {
    if (vec)
      db_fused_kernel<4, false><<<grid, block, 0, st>>>(s, out, n, amin, inv, coef, 0.f, slot);
    else
      db_fused_kernel<1, false><<<grid, block, 0, st>>>(s, out, n, amin, inv, coef, 0.f, slot);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6's per-item form over items of rows x cols values at s (item b, row r,
// column c at s + b s_item + r s_row + c), the result dense (items, rows,
// cols) at out: out = maximum(dB, its item's maximum less top_db) * scale +
// offset with has_top_db (db_item_max_kernel into slot, then db_item_kernel),
// dB * scale + offset without (db_item_kernel alone), on the stream. slot
// holds n_slot floats, at least the larger of db_fused_slots() and items; an
// item holds at most INT32_MAX values.
extern "C" int db_item_launch(const float* s, float* out, long long items, long long rows,
                              long long cols, long long s_item, long long s_row, float amin,
                              float inv, float coef, int has_top_db, float top_db, float scale,
                              float offset, float* slot, long long n_slot, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (items <= 0 || rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  err = static_cast<cudaError_t>(db_fused_slots(device, &slots));
  if (err != cudaSuccess) return static_cast<int>(err);
  // chunks an item: the grid near one resident wave, a chunk at least 1024
  // values
  const long long n = rows * cols, per_block = 4LL * kThreads;
  long long bpi = slots / items;
  if (bpi > (n + per_block - 1) / per_block) bpi = (n + per_block - 1) / per_block;
  if (bpi < 1) bpi = 1;
  if (n > INT32_MAX || items * bpi > n_slot || items * bpi > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(items * bpi)), block(kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(bpi), n32 = static_cast<int>(n), w = static_cast<int>(cols);
  if (has_top_db) {
    db_item_max_kernel<<<grid, block, 0, st>>>(s, n32, w, s_item, s_row, c, amin, inv, coef, slot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    db_item_kernel<true><<<grid, block, 0, st>>>(s, out, n32, w, s_item, s_row, c, amin, inv, coef,
                                                 top_db, scale, offset, slot);
  } else {
    db_item_kernel<false><<<grid, block, 0, st>>>(s, out, n32, w, s_item, s_row, c, amin, inv,
                                                  coef, 0.f, scale, offset, slot);
  }
  return static_cast<int>(cudaGetLastError());
}
