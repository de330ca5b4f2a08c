// K7: per-frame statistics of time-domain frames: the zero-crossing rate
// (zero_crossing_rate) and the root-mean-square energy (rms), one float a
// frame, (B, 1, F).
//
// Replaces no pallas_call: the JAX package computes both in XLA
// (mlx_audio_primitives_tpu/ops/features.py::zero_crossing_rate,
// ops/framing.py::rms). Before this kernel the port ran each as PyTorch
// passes over an unfold view of the centre-padded signal: RMS squared the
// frames into a new (B, F, frame_length) tensor and read it back for its
// mean; ZCR gathered the edge pad, wrote the frames' sign bits, compared
// shifted views, cast the comparison to float32 and read that back for its
// sum. At 64 x 30 s (frame 2048, hop 512) those intermediates are 677 MB
// each, against 169 MB of audio and 0.33 MB of output.
//
// What bounds it on this card: device-memory bytes, one read of the audio
// and one write of a float a frame (169.7 MB at 64 x 30 s, 0.0507 ms at
// 3.35 TB/s); a frame costs two operations a sample.
//
// The design reads the audio from device memory once. A block takes a tile
// of FT consecutive frames of one clip (the launcher sizes it so that the
// tile's segment, (FT - 1) * hop + frame_length samples, fits in 40 KB: 16
// frames of 2048 at hop 512, 38 KB, five blocks an SM) and stages the
// segment in shared memory with 16-byte cp.async copies (fft_common.cuh's
// stage_segment: a segment that reaches past the clip's edges is read
// through padded_sample instead, so the centre pad is never written to
// device memory: zeros for 'constant', the clamped index for 'edge'). The
// frames' 4x overlap (frame 2048 at hop 512) is then served from shared
// memory; the segments of neighbouring tiles overlap by frame_length - hop
// samples, which the L2 serves, since neighbouring tiles run at the same
// time. Then each warp reduces whole frames of the tile:
// - ZCR: first the segment's sign bits (__float_as_uint(x) >> 31, so -0.0
//   and a NaN count as torch.signbit reads them) as 32-bit words, one warp
//   vote a 32 samples, once for all the tile's frames (a 4x overlap would
//   otherwise vote each sample four times); then a frame's changes between
//   neighbours are the popcounts of w ^ (w << 1 | the word before's last
//   bit) over its words, masked at both ends, frame_length - 1 pairs in all,
//   summed over the warp. The count is exact, so the rate is the twin's bit
//   for bit: count * (1 / frame_length), the reciprocal rounded to float32
//   on the host, as PyTorch's CUDA division by a host scalar forms it.
// - RMS: each lane sums the squares of its samples in float32 (FMA, one
//   partial per float of a 16-byte step where the frame starts 16-byte
//   aligned in the segment, hop, frame_length and the segment's offset
//   multiples of four floats; a float a step otherwise), then a five-step
//   XOR tree sums the warp's; sqrt(sum * (1 / frame_length)). Every frame is
//   summed on its own: no running sum across frames, which would cancel.
//   The twin sums in another order (PyTorch's reduction): ~1e-7 of its
//   largest value apart.
// One launch a call, no atomics, nothing written but the output.
#include <cuda_runtime.h>

#include <cstdint>

#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// floats of a tile's segment the launcher aims for (40 KB: 16 frames of 2048
// at hop 512, five blocks an SM; on an H100 tiles of 8 frames read 4-5%
// slower for ZCR and 2% faster for RMS, of 32 frames 6-28% slower for both),
// the most frames a tile, and the longest frame (its segment alone, 64 KB)
constexpr int kSegBudget = 10240;
constexpr int kMaxTileFrames = 64;
constexpr int kMaxFrameLength = 16384;

enum Stat { kZcr = 0, kRms = 1 };

__device__ __forceinline__ unsigned sign_of(float x) { return __float_as_uint(x) >> 31; }

// The floats of a tile's segment in shared memory: its samples and the three
// floats stage_segment may shift them by, rounded up to 16 bytes; ZCR's
// sign words follow, one a 32 samples.
__host__ __device__ constexpr int seg_cap(int ft, int hop, int n) {
  return ((ft - 1) * hop + n + 3 + 3) & ~3;
}

// ZCR of the frame whose sample pairs (i - 1, i) are i in [lo, hi) of the
// segment, from its sign words sw (bit l of word w: the sign of sample
// 32 w + l), in every lane: the popcounts of the words' changes, masked at
// both ends, summed over the warp.
__device__ __forceinline__ float frame_zcr(const unsigned* sw, int lo, int hi, float inv,
                                           int lane) {
  const int w_lo = lo / 32, w_hi = (hi - 1) / 32;
  unsigned count = 0;
  for (int w = w_lo + lane; w <= w_hi; w += 32) {
    const unsigned c = sw[w] ^ ((sw[w] << 1) | (w > 0 ? sw[w - 1] >> 31 : 0u));
    unsigned mask = kFull;
    if (w == w_lo) mask &= kFull << (lo % 32);
    if (w == w_hi) mask &= kFull >> (31 - (hi - 1) % 32);
    count += __popc(c & mask);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);
  return __fmul_rn(static_cast<float>(count), inv);
}

// RMS of the frame at seg[0 .. n) in shared memory, V floats a lane a step
// (V = 4: seg 16-byte aligned and n a multiple of 4), in every lane.
template <int V>
__device__ __forceinline__ float frame_rms(const float* seg, int n, float inv, int lane) {
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int j = V * lane; j < n; j += 32 * V) {
    if constexpr (V == 4) {
      const float4 x = *reinterpret_cast<const float4*>(seg + j);
      acc[0] = fmaf(x.x, x.x, acc[0]);
      acc[1] = fmaf(x.y, x.y, acc[1]);
      acc[2] = fmaf(x.z, x.z, acc[2]);
      acc[3] = fmaf(x.w, x.w, acc[3]);
    } else {
      acc[0] = fmaf(seg[j], seg[j], acc[0]);
    }
  }
  float s = acc[0];
  if constexpr (V == 4) s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return sqrtf(__fmul_rn(s, inv));
}

// Block (clip b, tile t): frames t * ft .. of clip b, padded by pad samples
// on each side (mode: fft_common.cuh's padded_sample codes)
template <int STAT>
__global__ void __launch_bounds__(kThreads)
frame_stats_kernel(const float* __restrict__ y, long long L, float* __restrict__ out, int n,
                   int hop, int F, int pad, int mode, int ft, int tiles, float inv) {
  extern __shared__ float4 smem4[];
  float* seg = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x / tiles, f0 = (blockIdx.x % tiles) * ft;
  const int nf = min(ft, F - f0), len = (nf - 1) * hop + n;
  const int off = mapt::stage_segment(y + static_cast<long long>(b) * L, L,
                                      static_cast<long long>(f0) * hop - pad, len, mode, seg,
                                      threadIdx.x, kThreads);
  mapt::cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* o = out + static_cast<long long>(b) * F + f0;
  if constexpr (STAT == kZcr) {
    // the segment's sign words, once for all its frames (a warp vote a 32
    // samples), then each frame's changes from them
    unsigned* sw = reinterpret_cast<unsigned*>(seg + seg_cap(ft, hop, n));
    const float* s = seg + off;
    for (int w = warp; w * 32 < len; w += kWarps) {
      const int i = 32 * w + lane;
      const unsigned bits = __ballot_sync(kFull, i < len ? sign_of(s[i]) : 0u);
      if (lane == 0) sw[w] = bits;
    }
    __syncthreads();
    for (int k = warp; k < nf; k += kWarps) {
      const float v = frame_zcr(sw, k * hop + 1, k * hop + n, inv, lane);
      if (lane == 0) o[k] = v;
    }
  } else {
    const bool vec = off == 0 && hop % 4 == 0 && n % 4 == 0;
    for (int k = warp; k < nf; k += kWarps) {
      const float* frame = seg + off + k * hop;
      const float v = vec ? frame_rms<4>(frame, n, inv, lane) : frame_rms<1>(frame, n, inv, lane);
      if (lane == 0) o[k] = v;
    }
  }
}

template <int STAT>
cudaError_t launch(const float* y, long long B, long long L, float* out, int n, int hop, int F,
                   int pad, int mode, float inv, cudaStream_t stream) {
  // frames a tile: as many as fit the budget, at least one, whole rounds of
  // the block's warps where there are more frames than warps
  long long ft = n < kSegBudget ? (kSegBudget - n) / hop + 1 : 1;
  if (ft > kMaxTileFrames) ft = kMaxTileFrames;
  if (ft > F) ft = F;
  if (ft > kWarps) ft -= ft % kWarps;
  const long long tiles = (F + ft - 1) / ft;
  if (B * tiles > INT32_MAX) return cudaErrorInvalidValue;
  // the segment, and ZCR's sign words
  const int cap = seg_cap(static_cast<int>(ft), hop, n);
  const size_t bytes = sizeof(float) * (cap + (STAT == kZcr ? (cap + 31) / 32 : 0));
  const cudaError_t err =
      mapt::allow_smem(reinterpret_cast<const void*>(frame_stats_kernel<STAT>), bytes);
  if (err != cudaSuccess) return err;
  frame_stats_kernel<STAT><<<static_cast<unsigned>(B * tiles), kThreads, bytes, stream>>>(
      y, L, out, n, hop, F, pad, mode, static_cast<int>(ft), static_cast<int>(tiles), inv);
  return cudaGetLastError();
}

}  // namespace

// out (B, F) = the statistic (0 ZCR, 1 RMS) of each frame of y (B, L),
// frames of n samples at hop after a pad of `pad` samples a side (mode 0
// constant, 1 reflect, 2 edge); inv = 1 / n in float32.
extern "C" int frame_stats_launch(const float* y, long long B, long long L, float* out, int n,
                                  int hop, int F, int pad, int mode, int stat, float inv,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || n <= 0 || n > kMaxFrameLength || hop <= 0 || F <= 0 || pad < 0 ||
      static_cast<long long>(F - 1) * hop + n > L + 2LL * pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stat == kZcr) return static_cast<int>(launch<kZcr>(y, B, L, out, n, hop, F, pad, mode, inv, st));
  if (stat == kRms) return static_cast<int>(launch<kRms>(y, B, L, out, n, hop, F, pad, mode, inv, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
