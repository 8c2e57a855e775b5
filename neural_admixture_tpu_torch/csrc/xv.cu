// xv: Xp = X @ V straight from 2-bit packed genotype rows, on Hopper.
//
// Replaces the JAX package's Pallas kernel ops/fused_step.py:99 _xv_kernel
// (through :598 _xv_call and :761 fused_infer_q): the projection of every
// batch onto the PCA basis V, the first op of projective inference, of each
// training step's forward and of the post-training Q pass.
//
//   packed (B, W) uint8, row-major, 4 SNPs per byte (SNP j at bits 2(j%4) of
//          byte j/4), read as little-endian u32 words in natural SNP order;
//   V      (m_pad, D) fp32 with m_pad = 4W, D <= 32;
//   Xp     (B, D) fp32,  Xp[b, d] = sum_m x(b, m) V[m, d],
//          x = g/2 for the 2-bit code g, and 0 for code 3 (missing).
//
// Precision: fp32 throughout (no TF32, no bf16). The kernel multiplies the
// raw code g in {0, 1, 2} and halves each partial sum once at the end, which
// is exact in fp32 (halving commutes with rounding). The TPU kernel fed bf16
// operands to its matrix unit; this one keeps full fp32 products.
//
// What bounds it on an H100 SXM: at the infer batch (B = 1024, m_pad =
// 1,001,472, D = 8) it reads 256 MB of packed rows + 32 MB of V (~86 us at
// 3.35 TB/s) and does 2*B*m_pad*D = 16.4 GFLOP (~245 us at the 67 TFLOP/s of
// the fp32 CUDA cores). On the CUDA cores it is compute-bound, with the
// decode (shift, mask, convert per genotype and row) on top of the D FMAs.
// Design against that:
//   * one decode of a genotype feeds all D FMAs, and each V value loaded
//     from shared memory feeds R rows (R = 8 for D <= 8), so shared-memory
//     traffic stays below the FMA rate;
//   * the missing -> 0 mask is applied to a whole 16-SNP word with 5 integer
//     ops, not per genotype (and compiled out when the host proved there is
//     no code 3: NO_MISSING);
//   * V is staged per 512-SNP chunk into shared memory in a field-major
//     order ([field b][float4 q][lane]), so the 32 lanes of a warp, each on
//     its own word, read 32 consecutive float4s: no bank conflicts. This
//     reorder is internal; V stays in natural SNP order in device memory;
//   * the grid splits M across blockIdx.y so that B/rows x n_split blocks
//     fill the 132 SMs; a second tiny kernel sums the (n_split, B, D)
//     partials in a fixed order. Results are deterministic, with no atomics;
//   * K7, the indexed form (the JAX package's ops/fused_step.py:560-595):
//     with blk_idx, batch row r is resident row blk_idx[r / blk] * blk +
//     r % blk, read in place instead of from a gathered copy. The indexed
//     instances (INDEXED) stage the word offsets of a block's 64 rows in
//     shared memory once (batch_row, unpack.cuh); the gathered ones keep
//     plain strides, which the table would slow by ~5%. Both run the same
//     arithmetic on the same rows, so they agree bit for bit.
// Reaching the memory bound needs the tensor cores (g is exact in bf16, V
// split into bf16 hi + lo parts, wgmma on the decoded tile); that is later
// work.
//
// Offsets are 64-bit: B*W passes 2^31 at biobank N.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkWords = 32;                // u32 words of a row per chunk
constexpr int kChunkSnps = kChunkWords * 16;   // 512 SNPs

// Rows a thread carries (acc registers = R * DT <= 64).
template <int DT>
struct RowsPerThread {
  static constexpr int value = DT <= 8 ? 8 : (DT == 16 ? 4 : 2);
};

template <int DT, bool NO_MISSING, bool INDEXED>
__global__ void __launch_bounds__(kThreads, 2)
xv_partial_kernel(const uint32_t* __restrict__ packed,
                  const float* __restrict__ V, float* __restrict__ partial,
                  const int32_t* __restrict__ blk_idx, int blk,
                  int64_t B, int64_t W4, int D, int64_t n_chunks,
                  int n_split) {
  constexpr int R = RowsPerThread<DT>::value;
  constexpr int Q = DT / 4;
  extern __shared__ float4 vs[];  // [16][Q][32] float4 = kChunkSnps*DT floats
  __shared__ int64_t row_off[kWarps * R];  // INDEXED: each row's offset

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.y;
  const int64_t block_row0 = (int64_t)blockIdx.x * (kWarps * R);
  const int64_t row0 = block_row0 + warp * R;
  const int64_t left = B - row0;
  const int n_rows = left < 0 ? 0 : (left < R ? (int)left : R);
  if constexpr (INDEXED) {
    for (int i = threadIdx.x; i < kWarps * R; i += kThreads)
      row_off[i] = block_row0 + i < B
                       ? batch_row(blk_idx, blk, block_row0 + i) * W4 : 0;
    __syncthreads();
  }
  const uint32_t* rows = packed + row0 * W4;
  const int64_t* offs = row_off + warp * R;
  // Word w of this warp's row r.
  auto word = [&](int r, int64_t w) {
    return INDEXED ? packed + offs[r] + w : rows + r * W4 + w;
  };
  const int64_t c0 = n_chunks * split / n_split;
  const int64_t c1 = n_chunks * (split + 1) / n_split;
  const int64_t m_pad = W4 * 16;

  float acc[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[r][d] = 0.f;

  uint32_t u_next[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t w = c0 * kChunkWords + lane;
    u_next[r] = (r < n_rows && c0 < c1 && w < W4) ? __ldg(word(r, w)) : 0u;
  }

  for (int64_t c = c0; c < c1; ++c) {
    uint32_t u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = u_next[r];

    __syncthreads();  // every warp is done with the previous chunk's V
    const int64_t s0 = c * kChunkSnps;
    for (int i = threadIdx.x; i < kChunkSnps * Q; i += kThreads) {
      const int l = i & 31;
      const int bq = i >> 5;
      const int q = bq % Q;
      const int b = bq / Q;
      const int64_t s = s0 + l * 16 + b;
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = q * 4 + j;
        e[j] = (s < m_pad && d < D) ? __ldg(V + s * D + d) : 0.f;
      }
      vs[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();

    // Prefetch the next chunk's words while this one computes.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t w = (c + 1) * kChunkWords + lane;
      u_next[r] = (r < n_rows && c + 1 < c1 && w < W4) ? __ldg(word(r, w))
                                                        : 0u;
    }
    if (!NO_MISSING) {
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = unpack_word(u[r]);
    }

#pragma unroll
    for (int b = 0; b < 16; ++b) {
      float4 v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = vs[(b * Q + q) * 32 + lane];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = (float)((u[r] >> (2 * b)) & 3u);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          acc[r][4 * q + 0] = fmaf(x, v[q].x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(x, v[q].y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(x, v[q].z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(x, v[q].w, acc[r][4 * q + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float s = acc[r][d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[r][d] = s;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n_rows) {
        float* dst = partial + ((int64_t)split * B + row0 + r) * D;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          if (d < D) dst[d] = 0.5f * acc[r][d];
      }
    }
  }
}

// out[i] = sum over splits of partial[k][i], k in a fixed order.
__global__ void xv_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int64_t n,
                                 int n_split) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += partial[(int64_t)k * n + i];
  out[i] = s;
}

template <int DT, bool NO_MISSING, bool INDEXED>
cudaError_t launch(const uint32_t* packed, const float* V, float* partial,
                   float* out, const int32_t* blk_idx, int blk, int64_t B,
                   int64_t W4, int D, int n_split, cudaStream_t stream) {
  const size_t smem = (size_t)kChunkSnps * DT * sizeof(float);
  auto kernel = xv_partial_kernel<DT, NO_MISSING, INDEXED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * RowsPerThread<DT>::value;
  const int64_t n_chunks = (W4 + kChunkWords - 1) / kChunkWords;
  dim3 grid((unsigned)((B + rows_per_block - 1) / rows_per_block),
            (unsigned)n_split);
  kernel<<<grid, kThreads, smem, stream>>>(
      packed, V, partial, blk_idx, blk, B, W4, D, n_chunks, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = B * D;
  xv_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, out, n, n_split);
  return cudaGetLastError();
}

template <int DT>
cudaError_t dispatch_missing(const uint32_t* packed, const float* V,
                             float* partial, float* out,
                             const int32_t* blk_idx, int blk, int64_t B,
                             int64_t W4, int D, int n_split, int no_missing,
                             cudaStream_t stream) {
#define NA_XV_LAUNCH(N, I) \
  launch<DT, N, I>(packed, V, partial, out, blk_idx, blk, B, W4, D, n_split, \
                   stream)
  switch ((no_missing ? 2 : 0) | (blk_idx != nullptr ? 1 : 0)) {
    case 0: return NA_XV_LAUNCH(false, false);
    case 1: return NA_XV_LAUNCH(false, true);
    case 2: return NA_XV_LAUNCH(true, false);
    default: return NA_XV_LAUNCH(true, true);
  }
#undef NA_XV_LAUNCH
}

}  // namespace

extern "C" {

// Rows of the batch one block covers, for the caller's split plan.
int na_xv_rows_per_block(int D) {
  if (D <= 4) return kWarps * RowsPerThread<4>::value;
  if (D <= 8) return kWarps * RowsPerThread<8>::value;
  if (D <= 16) return kWarps * RowsPerThread<16>::value;
  return kWarps * RowsPerThread<32>::value;
}

// SNP chunks of 512 a row holds: the most splits that get work.
long long na_xv_chunks(long long W) {
  const long long W4 = W / 4;
  return (W4 + kChunkWords - 1) / kChunkWords;
}

// packed: (rows, W) uint8, W % 4 == 0, 4-byte aligned: the batch itself
// (blk_idx null, rows = B) or the resident rows that the (B / blk,) int32
// blk_idx indexes (K7); V: (4W, D) fp32; partial: (n_split, B, D) fp32
// scratch; out: (B, D) fp32. Returns the cudaError_t of the launches
// (0 = cudaSuccess). 1 <= D <= 32.
int na_xv(const void* packed, const void* V, void* partial, void* out,
          long long B, long long W, int D, int n_split, int no_missing,
          const void* blk_idx, int blk, void* stream) {
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  const float* v = static_cast<const float*>(V);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  const int32_t* bi = static_cast<const int32_t*>(blk_idx);
  const int64_t W4 = W / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bi != nullptr && (blk < 1 || B % blk)) return (int)cudaErrorInvalidValue;
  if (D < 1) return (int)cudaErrorInvalidValue;
  if (D <= 4)
    return dispatch_missing<4>(p, v, part, o, bi, blk, B, W4, D, n_split,
                               no_missing, s);
  if (D <= 8)
    return dispatch_missing<8>(p, v, part, o, bi, blk, B, W4, D, n_split,
                               no_missing, s);
  if (D <= 16)
    return dispatch_missing<16>(p, v, part, o, bi, blk, B, W4, D, n_split,
                                no_missing, s);
  if (D <= 32)
    return dispatch_missing<32>(p, v, part, o, bi, blk, B, W4, D, n_split,
                                no_missing, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
