// The TF32 tensor-core path shared by dq_dp (K3/K4) and bce_sum (K6): the
// mma, and the split of an fp32 operand into two TF32 pieces for 3xTF32.
//
// v = big + small, both TF32 (fp32 bits with the low 13 bits zero); a
// product is small*big + big*small + big*big, accumulated in fp32. split:
// each piece rounded to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives for finite v), within about 2^-22 relative;
// values on a 2^-10 grid (at most 11 significant bits) split exactly
// (small = 0). split_fast: each piece truncated, within 2^-20, in three
// instructions where split takes five.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void split_fast(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// c += a b on the tensor cores, m16n8k8, TF32 operands, fp32 accumulator.
// Fragment maps (lane = 4g + t): A (16x8) a0 (g, t), a1 (g+8, t), a2 (g,
// t+4), a3 (g+8, t+4); B (8x8) b0 (t, g), b1 (t+4, g); C (16x8) c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1) (CUTLASS's
// SM80_16x8x8_F32TF32TF32F32_TN).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
