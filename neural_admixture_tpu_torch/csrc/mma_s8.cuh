// The int8 tensor-core path shared by xv (K2) and dv (K5): the mma, and the
// cut of an fp32 operand into a power-of-two scale and int8 pieces.
//
// A column of fp32 values (V per SNP chunk in xv, dXp per row chunk in dv)
// takes the scale 2^e with e the smallest integer for which amax 2^-e <=
// 127 2^(8 (P - 1)), P the number of pieces; q = rint(value 2^-e) is cut
// into P balanced int8 pieces, q = sum_k p_k 256^k. The 2-bit codes are
// exact int8, so each piece's sum of products is exact in the mma's int32
// accumulator over a chunk; fold() puts the pieces' sums together exactly
// in int64 and rounds once to fp32.

#pragma once

#include <stdint.h>

constexpr int kMinExp = -100;  // 2^e and 2^-e stay normal

// c += a b on the tensor cores, m16n8k32, int8 operands, int32 accumulator.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// The smallest e with amax 2^-e <= 127 2^(8 (P - 1)) (amax = m 2^E, m in
// [0.5, 1): E - s or E - s + 1, s = 8 P - 1; P = 3: E - 23 or E - 22), at
// least kMinExp; 0 for a zero column.
template <int P = 3>
__device__ __forceinline__ int scale_exp(float amax) {
  if (!(amax > 0.f)) return 0;
  int E;
  const float m = frexpf(amax, &E);
  constexpr int s = 8 * P - 1;
  const int e = m * 8388608.f <= 8323072.f ? E - s : E - s + 1;
  return max(e, kMinExp);
}

__device__ __forceinline__ float exp2i(int e) {  // 2^e, e in [-126, 127]
  return __int_as_float((127 + e) << 23);
}

// q = lo + 256 mid + 65536 hi, each piece in [-128, 127] for |q| <= 127 2^16.
__device__ __forceinline__ void cut(int q, int& lo, int& mid, int& hi) {
  lo = ((q + 128) & 255) - 128;
  const int r1 = (q - lo) >> 8;
  mid = ((r1 + 128) & 255) - 128;
  hi = (r1 - mid) >> 8;
}

// Four pieces, lowest first: q = sum_k p[k] 256^k, each in [-128, 127] for
// |q| <= 127 2^24.
__device__ __forceinline__ void cut(int q, int (&p)[4]) {
  int r = q;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = ((r + 128) & 255) - 128;
    r = (r - p[k]) >> 8;
  }
  p[3] = r;
}

// The chunk's sum of g v of one output, from the pieces' accumulators:
// exact in int64, rounded once to fp32.
__device__ __forceinline__ float fold(int32_t hi, int32_t mid, int32_t lo) {
  return __ll2float_rn((int64_t)hi * 65536 + (mid * 256 + lo));
}

// The same with four pieces, acc[k] the sum of g p_k.
__device__ __forceinline__ float fold(const int32_t (&acc)[4]) {
  return __ll2float_rn((int64_t)acc[3] * 16777216 + (int64_t)acc[2] * 65536 +
                       (acc[1] * 256 + acc[0]));
}
