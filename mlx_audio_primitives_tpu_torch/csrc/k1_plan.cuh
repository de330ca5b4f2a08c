// K1's weight plan and the bf16 helpers of its contraction, shared by the
// fast entry (mel_fused.cu) and the mixed-radix entry K1m (mel_fused_mixed.cu).
//
// The plan (kernels/mel_fused.py::band_plan_host for a cached table, built
// once per table and device; mel_fused.cu's mel_fused_fast_pack_kernel, through
// mel_fused_pack_launch, for a W given per call), int32 words:
//   [0] kPlanMagic, [1] n_cols, [2] n_mt, [3] ksteps, [4] blocks, [5..7] 0;
//   [kPlanHeader + mt], mt <= n_mt: the blocks of the m-tiles before mt;
//   [kPlanHeader + n_mt + 1 + mt], mt < n_mt: the m-tile's first k-step;
//   from plan_w_offset(n_mt) (16-byte aligned): W^T split into bf16
//   hi = bf16_rn(x) and lo = bf16_rn(x - hi), zero-padded to 16 n_mt columns
//   and ksteps k-steps of 16 bins, 16 words a (column, k-step), column by
//   column: for q = 0..3 the words hi(4q, 4q+1), hi(4q+2, 4q+3),
//   lo(4q, 4q+1), lo(4q+2, 4q+3), the even bin in the low half.
// A block is an (m-tile, k-step) pair; m-tile mt's columns are exactly zero
// outside its blocks (at least one; every k-step for a dense W). Thread q's
// 16-byte load at (column, k-step) is its A registers of that column: the
// k-step's bins permuted so that a thread's four are consecutive (fragment
// columns 2q, 2q+1 are bins 4q, 4q+1 and columns 2q+8, 2q+9 bins 4q+2,
// 4q+3; the B registers take the same permutation), hi and lo already split.
#pragma once

#include <cuda_bf16.h>

namespace mapt {

constexpr int kPlanMagic = 0x4B31BA4D;
constexpr int kPlanHeader = 8;

__host__ __device__ constexpr int plan_w_offset(int n_mt) {
  return (kPlanHeader + 2 * n_mt + 1 + 3) & ~3;
}

// c += a * b on the tensor cores (m16n8k16, bf16 in, FP32 accumulate)
static __device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 split of x0 (low half) and x1 (high half) as two packed words:
// hi = bf16_rn(x), lo = bf16_rn(x - hi), rounding to nearest even, as
// _bf16_split does (x - hi is exact in FP32)
static __device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi,
                                                    unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = reinterpret_cast<const unsigned&>(h);
  lo = reinterpret_cast<const unsigned&>(l);
}

}  // namespace mapt
