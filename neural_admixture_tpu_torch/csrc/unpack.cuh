// K1: the 2-bit genotype decode shared by every kernel of the port, and the
// row addressing of K7 (batches read by block id from the resident rows).
//
// Replaces the JAX package's ops/fused.py:181 _unpack_x (with
// ops/fused_step.py:68 _unpack_cat and :80 _unpack_m). Packed rows are read
// as little-endian u32 words, word w holding SNPs 16w .. 16w+15 in natural
// order, SNP 16w+b at bits 2b, 2b+1 (see ops/pack.py).

#pragma once

#include <stdint.h>

// Zeroes every code-3 (missing) field of a 16-SNP word in 5 integer ops; the
// per-field value is then (u >> 2b) & 3, the raw dosage g in {0, 1, 2}.
__device__ __forceinline__ uint32_t unpack_word(uint32_t u) {
  const uint32_t m = u & (u >> 1) & 0x55555555u;  // low bit of each 0b11 field
  return u & ~(m | (m << 1));
}

// The packed row that logical batch row r reads. A gathered batch
// (blk_idx == nullptr) is its own array: row r. An indexed batch (K7, the
// JAX package's ops/fused_step.py:483-504 and :560-595) reads the resident
// array in place: row r % blk of the sampled block blk_idx[r / blk]. The
// kernels call this once per row when they stage a block's rows, and keep
// the result in shared memory.
__device__ __forceinline__ int64_t batch_row(const int32_t* blk_idx, int blk,
                                             int64_t r) {
  if (blk_idx == nullptr) return r;
  return (int64_t)__ldg(blk_idx + r / blk) * blk + r % blk;
}
