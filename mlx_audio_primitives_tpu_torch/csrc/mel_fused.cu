// K1: fused filterbank spectrogram, |rFFT(window * frame)|^p @ W.
//
// Replaces mlx_audio_primitives_tpu/kernels/mel_fused.py::melspectrogram_pallas
// (pallas_call in _mel_radix_core). One block takes one clip and a tile of
// FB frames (8 to 32; the layout keeps two blocks on an SM where it can):
//   1. in sub-batches of FS frames: stage the sub-batch's signal segment in
//      shared memory with the centre padding applied on the fly (framing is
//      index math), window, pack and FFT it (fft_common.cuh::frames_fft),
//      split into the n_bins = N/2+1 real-FFT bins and keep |X|^2 (or |X|)
//      as one power row per frame in shared memory;
//   2. contract the FB power rows with the dense (n_bins, n_cols) matrix W:
//      W streams through shared memory in double-buffered tiles of 16 bins
//      x 128 columns, and each thread accumulates a register tile of FB/8
//      frames x 4 columns, so each W element read from device memory serves
//      FB frames;
//   3. write (B, n_cols, F) directly.
// Frames and spectrum never reach device memory. W may be any dense matrix
// (mel, chroma, a lag basis); mel sparsity is not used.
#include "fft_common.cuh"

namespace {

constexpr int kColTile = 128;  // columns per contraction pass
constexpr int kKTile = 16;     // bins per staged W tile
constexpr int kSmemLimit = 227 * 1024;

struct MelLayout {
  int fb, fs;                 // frames per block, frames per FFT sub-batch
  int nb4;                    // power-row stride (n_bins rounded up to 4)
  int p, buf, seg, wt;        // region sizes in floats, each a multiple of 4
  size_t bytes() const { return sizeof(float) * size_t(p + buf + seg + wt); }
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline MelLayout mel_layout(int n_fft, int hop, int fb, int fs) {
  const int m = n_fft / 2;
  MelLayout l;
  l.fb = fb;
  l.fs = fs;
  l.nb4 = round4(m + 1);
  l.p = fb * l.nb4;
  l.buf = round4(fs * mapt::frame_stride(m) * 2);
  l.seg = round4((fs - 1) * hop + n_fft);
  l.wt = 2 * kKTile * kColTile;
  return l;
}

// The largest tile with two blocks per SM (FB from 32 down to 8 frames,
// then FS from 8 down to 1), else the largest with one. Two blocks per SM
// let one block's FFT overlap the other's contraction: at n_fft 2048 the
// kernel ran ~18% faster with FB 16 and two blocks than with FB 32 and one
// (H100 80GB HBM3, 700 W power limit).
inline MelLayout pick_layout(int n_fft, int hop) {
  for (size_t budget : {size_t(kSmemLimit / 2) - 1024, size_t(kSmemLimit)}) {
    for (int fb = 32; fb >= 8; fb -= 8)
      for (int fs = 8; fs >= 1; fs /= 2) {
        const MelLayout l = mel_layout(n_fft, hop, fb, fs);
        if (fb % fs == 0 && l.bytes() <= budget) return l;
      }
  }
  return mel_layout(n_fft, hop, 8, 1);
}

// TF = FB/8 frames per thread in the contraction, a template parameter: with
// a runtime count the accumulator tile stays predicated, and the contraction
// ran ~35% slower (H100 80GB HBM3, 700 W power limit).
template <int TF>
__global__ void __launch_bounds__(mapt::kThreads)
mel_fused_kernel(const float* __restrict__ y, long long L,
                 const float* __restrict__ win,
                 const float2* __restrict__ tw,
                 const float* __restrict__ W,
                 float* __restrict__ out,
                 int n_fft, int log_m, int hop, int F, int n_cols,
                 int pad, int mode, int power, int fs) {
  constexpr int fb = 8 * TF;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m = 1 << log_m;
  const int n_bins = m + 1;
  const MelLayout lay = mel_layout(n_fft, hop, fb, fs);
  const int nb4 = lay.nb4;
  float* P = smem;
  float2* buf = reinterpret_cast<float2*>(smem + lay.p);
  float* seg = smem + lay.p + lay.buf;
  float* wt = seg + lay.seg;  // two W tiles
  const int stride = mapt::frame_stride(m);
  const int b = blockIdx.y;
  const long long f0 = static_cast<long long>(blockIdx.x) * fb;
  const float* yb = y + static_cast<long long>(b) * L;

  // 1. power rows, FS frames at a time
  for (int sub = 0; sub < fb; sub += fs) {
    mapt::frames_fft(yb, L, win, tw, seg, buf, n_fft, log_m, hop, f0 + sub, pad, mode, fs);
    for (int f = 0; f < fs; ++f) {
      float* row = P + (sub + f) * nb4;
      for (int k = threadIdx.x; k < nb4; k += blockDim.x) {
        float p = 0.f;  // zero tail up to nb4: the float4 contraction reads it
        if (k < n_bins) {
          const float2 X = mapt::rfft_bin(buf + f * stride, k, m, tw);
          p = X.x * X.x + X.y * X.y;
          if (power == 1) p = sqrtf(p);
        }
        row[k] = p;
      }
    }
    // the next frames_fft overwrites buf only after its first barrier
  }
  __syncthreads();

  // 2. out[b, col, f] = sum_k P[f, k] * W[k, col]
  const int cg = threadIdx.x & 31;  // columns 4*cg .. 4*cg+3 of the column tile
  const int g = threadIdx.x >> 5;   // frames g*TF .. g*TF+TF-1
  const int n_ktiles = (nb4 + kKTile - 1) / kKTile;
  for (int c0 = 0; c0 < n_cols; c0 += kColTile) {
    float acc[TF][4];
#pragma unroll
    for (int i = 0; i < TF; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    // each thread stages kKTile/2 W elements per tile: rows wr, wr+2, ...
    constexpr int kStage = kKTile * kColTile / mapt::kThreads;
    const int wc = threadIdx.x & (kColTile - 1), wr = threadIdx.x >> 7;  // wr in {0, 1}
    const bool col_ok = c0 + wc < n_cols;
    float stage[kStage];
    auto fetch = [&](int kt) {
#pragma unroll
      for (int r = 0; r < kStage; ++r) {
        const int k = kt * kKTile + wr + 2 * r;
        stage[r] = (col_ok && k < n_bins) ? W[static_cast<long long>(k) * n_cols + c0 + wc] : 0.f;
      }
    };
    auto put = [&](int slot) {
      float* t = wt + slot * kKTile * kColTile;
#pragma unroll
      for (int r = 0; r < kStage; ++r) t[(wr + 2 * r) * kColTile + wc] = stage[r];
    };
    fetch(0);
    put(0);
    __syncthreads();
    for (int kt = 0; kt < n_ktiles; ++kt) {
      if (kt + 1 < n_ktiles) fetch(kt + 1);  // in flight during this tile's math
      const float* t = wt + (kt & 1) * kKTile * kColTile;
      const int kbase = kt * kKTile;
#pragma unroll
      for (int kk = 0; kk < kKTile; kk += 4) {
        if (kbase + kk < nb4) {
          float4 w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            w[r] = *reinterpret_cast<const float4*>(t + (kk + r) * kColTile + 4 * cg);
#pragma unroll
          for (int i = 0; i < TF; ++i) {
            const float4 p = *reinterpret_cast<const float4*>(P + (g * TF + i) * nb4 + kbase + kk);
            acc[i][0] += p.x * w[0].x + p.y * w[1].x + p.z * w[2].x + p.w * w[3].x;
            acc[i][1] += p.x * w[0].y + p.y * w[1].y + p.z * w[2].y + p.w * w[3].y;
            acc[i][2] += p.x * w[0].z + p.y * w[1].z + p.z * w[2].z + p.w * w[3].z;
            acc[i][3] += p.x * w[0].w + p.y * w[1].w + p.z * w[2].w + p.w * w[3].w;
          }
        }
      }
      if (kt + 1 < n_ktiles) put((kt + 1) & 1);
      __syncthreads();
    }

    // 3. store
#pragma unroll
    for (int i = 0; i < TF; ++i) {
      const long long f = f0 + g * TF + i;
      if (f < F) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 4 * cg + c;
          if (col < n_cols) out[(static_cast<long long>(b) * n_cols + col) * F + f] = acc[i][c];
        }
      }
    }
  }
}

template <int TF>
cudaError_t launch(const float* y, long long L, const float* win, const float* tw,
                   const float* W, float* out, int B, int n_fft, int hop, int F,
                   int n_cols, int pad, int mode, int power, const MelLayout& lay,
                   cudaStream_t stream) {
  const size_t smem = lay.bytes();
  cudaError_t err = mapt::allow_smem(reinterpret_cast<const void*>(mel_fused_kernel<TF>), smem);
  if (err != cudaSuccess) return err;
  const int log_m = __builtin_ctz(static_cast<unsigned>(n_fft / 2));
  const dim3 grid((F + lay.fb - 1) / lay.fb, B);
  mel_fused_kernel<TF><<<grid, mapt::kThreads, smem, stream>>>(
      y, L, win, reinterpret_cast<const float2*>(tw), W, out, n_fft, log_m, hop, F,
      n_cols, pad, mode, power, lay.fs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mel_fused_launch(const float* y, long long L, const float* win,
                                const float* tw, const float* W, float* out,
                                int B, int n_fft, int hop, int F, int n_cols,
                                int pad, int mode, int power, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MelLayout lay = pick_layout(n_fft, hop);
  if (lay.bytes() > kSmemLimit) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAPT_MEL(TF) \
  launch<TF>(y, L, win, tw, W, out, B, n_fft, hop, F, n_cols, pad, mode, power, lay, st)
  switch (lay.fb / 8) {
    case 1: err = MAPT_MEL(1); break;
    case 2: err = MAPT_MEL(2); break;
    case 3: err = MAPT_MEL(3); break;
    default: err = MAPT_MEL(4); break;
  }
#undef MAPT_MEL
  return static_cast<int>(err);
}
