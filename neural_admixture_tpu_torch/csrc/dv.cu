// dv: dV = X^T dXp straight from 2-bit packed genotype rows, on Hopper.
//
// Replaces the JAX package's Pallas kernel ops/fused_step.py:319 _dvt_kernel
// (through :734 _dv_call, kernel K5): the gradient of the PCA basis V, the
// last of a training step's three packed passes, after the encoder's
// backward has turned dQ into dXp.
//
//   packed (B, W) uint8, row-major, read as little-endian u32 words in
//          natural SNP order;
//   dXp    (B, D) fp32, D <= 32;
//   dV     (m_pad, D) fp32 with m_pad = 4W, in natural order (the TPU kernel
//          wrote dV^T for its lane layout; no transpose is needed here),
//          dV[m, d] = sum_b x(b, m) dXp[b, d],
//          x = g/2 for the 2-bit code g, and 0 for code 3 (missing).
//
// Precision: fp32 throughout. The kernel multiplies the raw code g in
// {0, 1, 2} and halves each sum once at the end, which is exact in fp32;
// the TPU kernel fed bf16 operands to its matrix unit.
//
// What bounds it on an H100 SXM: at the training batch (B = 800, m_pad =
// 1,001,472, D = 8) it does 2 B m_pad D = 12.8 GFLOP, ~0.19 ms at the
// 67 TFLOP/s of the fp32 CUDA cores, and moves ~232 MB (packed rows, dXp,
// dV), ~0.07 ms at 3.35 TB/s: operations bound it, with the decode (shift,
// mask, convert per genotype) on top of the D FMAs. The reduction runs over
// the batch only, so it needs no second pass. Design against that:
//   * a block owns 256 S consecutive SNPs (S = 64/DT per thread) and loops
//     over every batch row; each thread keeps its S x DT sums in registers
//     for the whole batch and writes them once;
//   * dXp is staged in shared memory (8192/DT rows at a time, 32 KB) and
//     read as broadcast float4s, so one decoded genotype feeds DT FMAs and
//     one dXp load feeds S genotypes;
//   * the missing -> 0 mask costs 5 integer ops per 16-SNP word (compiled
//     out when the host proved there is no code 3: NO_MISSING); the next
//     row's word is prefetched while a row computes;
//   * K7, the indexed form (the JAX package's ops/fused_step.py:560-595):
//     with blk_idx, batch row r reads resident row blk_idx[r / blk] * blk +
//     r % blk in place. The indexed instances (INDEXED) stage the packed
//     row of each batch row in shared memory beside its dXp (batch_row,
//     unpack.cuh); the gathered ones keep plain strides. The same
//     arithmetic in the same order, so the two agree bit for bit.
//
// Offsets are 64-bit: B*W and m_pad*D pass 2^31 at biobank sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

constexpr int kThreads = 256;

// Per DT (D rounded up to 4, 8, 16 or 32): SNPs a thread owns (its sums
// are S * DT = 64 registers) and the dXp rows staged per pass (INDEXED:
// with their packed rows, 4 bytes each).
template <int DT>
struct Geom {
  static constexpr int S = 64 / DT;
  static constexpr int kRows = 8192 / DT;
};

template <int DT, bool NO_MISSING, bool INDEXED>
__global__ void __launch_bounds__(kThreads, 2)
dv_kernel(const uint32_t* __restrict__ packed, const float* __restrict__ dXp,
          const int32_t* __restrict__ blk_idx, int blk,
          float* __restrict__ dV, int64_t B, int64_t W4, int D) {
  constexpr int S = Geom<DT>::S;
  constexpr int kRows = Geom<DT>::kRows;
  constexpr int Q = DT / 4;
  extern __shared__ float4 sx4[];  // [kRows][Q] float4, then [kRows] int32
  float* sx = reinterpret_cast<float*>(sx4);
  int* srow = reinterpret_cast<int*>(sx + kRows * DT);

  const int64_t m_pad = W4 * 16;
  const int64_t s0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * S;
  const int64_t w = s0 >> 4;
  const int shift = (int)(s0 & 15) * 2;
  const bool ok = w < W4;

  float acc[S][DT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[s][d] = 0.f;

  for (int64_t r0 = 0; r0 < B; r0 += kRows) {
    const int rows = (int)(B - r0 < kRows ? B - r0 : kRows);
    __syncthreads();  // every thread is done with the previous rows' dXp
    for (int i = threadIdx.x; i < rows * DT; i += kThreads) {
      const int b = i / DT, d = i % DT;
      sx[i] = d < D ? dXp[(r0 + b) * D + d] : 0.f;
    }
    if (INDEXED)
      for (int b = threadIdx.x; b < rows; b += kThreads)
        srow[b] = (int)batch_row(blk_idx, blk, r0 + b);
    __syncthreads();

    // This thread's word of batch row b (of this pass).
    const uint32_t* rows_p = INDEXED ? packed + w : packed + r0 * W4 + w;
    auto word = [&](int b) {
      return rows_p + (INDEXED ? (int64_t)srow[b] : (int64_t)b) * W4;
    };
    uint32_t u_next = ok ? __ldg(word(0)) : 0u;
    for (int b = 0; b < rows; ++b) {
      uint32_t u = u_next;
      u_next = (ok && b + 1 < rows) ? __ldg(word(b + 1)) : 0u;
      if (!NO_MISSING) u = unpack_word(u);
      u >>= shift;
      float4 v[Q];
#pragma unroll
      for (int qi = 0; qi < Q; ++qi) v[qi] = sx4[b * Q + qi];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float x = (float)((u >> (2 * s)) & 3u);
#pragma unroll
        for (int qi = 0; qi < Q; ++qi) {
          acc[s][4 * qi + 0] = fmaf(x, v[qi].x, acc[s][4 * qi + 0]);
          acc[s][4 * qi + 1] = fmaf(x, v[qi].y, acc[s][4 * qi + 1]);
          acc[s][4 * qi + 2] = fmaf(x, v[qi].z, acc[s][4 * qi + 2]);
          acc[s][4 * qi + 3] = fmaf(x, v[qi].w, acc[s][4 * qi + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int64_t m = s0 + s;
    if (m < m_pad) {
      float* dst = dV + m * D;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        if (d < D) dst[d] = 0.5f * acc[s][d];
    }
  }
}

template <int DT, bool NO_MISSING, bool INDEXED>
cudaError_t launch(const uint32_t* packed, const float* dXp,
                   const int32_t* blk_idx, int blk, float* dV, int64_t B,
                   int64_t W4, int D, cudaStream_t stream) {
  const size_t smem =
      (size_t)Geom<DT>::kRows * (DT + (INDEXED ? 1 : 0)) * sizeof(float);
  auto kernel = dv_kernel<DT, NO_MISSING, INDEXED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t snps_per_block = (int64_t)kThreads * Geom<DT>::S;
  const int64_t blocks = (W4 * 16 + snps_per_block - 1) / snps_per_block;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      packed, dXp, blk_idx, blk, dV, B, W4, D);
  return cudaGetLastError();
}

template <int DT>
cudaError_t dispatch(const uint32_t* packed, const float* dXp,
                     const int32_t* blk_idx, int blk, float* dV, int64_t B,
                     int64_t W4, int D, int no_missing, cudaStream_t s) {
#define NA_DV_LAUNCH(N, I) \
  launch<DT, N, I>(packed, dXp, blk_idx, blk, dV, B, W4, D, s)
  switch ((no_missing ? 2 : 0) | (blk_idx != nullptr ? 1 : 0)) {
    case 0: return NA_DV_LAUNCH(false, false);
    case 1: return NA_DV_LAUNCH(false, true);
    case 2: return NA_DV_LAUNCH(true, false);
    default: return NA_DV_LAUNCH(true, true);
  }
#undef NA_DV_LAUNCH
}

}  // namespace

extern "C" {

// packed: (rows, W) uint8, W % 4 == 0, 4-byte aligned: the batch itself
// (blk_idx null, rows = B) or the resident rows that the (B / blk,) int32
// blk_idx indexes (K7); dXp: (B, D) fp32; dV: (4W, D) fp32, every element
// written. Returns the cudaError_t of the launch (0 = cudaSuccess).
// 1 <= D <= 32, B >= 1.
int na_dv(const void* packed, const void* dXp, void* dV, long long B,
          long long W, int D, int no_missing, const void* blk_idx, int blk,
          void* stream) {
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  const float* x = static_cast<const float*>(dXp);
  const int32_t* bi = static_cast<const int32_t*>(blk_idx);
  float* out = static_cast<float*>(dV);
  const int64_t W4 = W / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (bi != nullptr && (blk < 1 || B % blk)) return (int)cudaErrorInvalidValue;
  if (D <= 4) return dispatch<4>(p, x, bi, blk, out, B, W4, D, no_missing, s);
  if (D <= 8) return dispatch<8>(p, x, bi, blk, out, B, W4, D, no_missing, s);
  if (D <= 16)
    return dispatch<16>(p, x, bi, blk, out, B, W4, D, no_missing, s);
  if (D <= 32)
    return dispatch<32>(p, x, bi, blk, out, B, W4, D, no_missing, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
