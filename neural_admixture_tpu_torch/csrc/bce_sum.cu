// bce_sum: the summed BCE of one head's decoder plane, straight from 2-bit
// packed genotype rows, on Hopper (kernel K6 of the port).
//
// Replaces the JAX package's Pallas kernel ops/fused_step.py:136
// _loss_kernel (through :625 _loss_call): the loss value of logged epochs
// under the split program (NA_TPU_SPLIT_LOSS=1, train/engine.py:421-422),
// whose gradients then come from K3 (dq_dp.cu) in the backward. Per element
// (b, m) of the batch plane:
//
//   raw = sum_j q[b,j] P[j,m],   rec = clamp(raw, 0, 1),   x = g(b,m)/2
//         (code 3, missing, decodes to x = 0)
//   loss += bce_elem(rec, x)   (bce.cuh, the one definition shared with K4:
//           -(x max(log rec, -100) + (1-x) max(log1p(-rec), -100)))
//   MASKED: each term times col_mask[m] row_w[b].
//
//   packed (rows, W) uint8 as little-endian u32 words, natural SNP order;
//   q (B, k), P (k, m_pad), col_mask (m_pad), row_w (B): fp32; m_pad = 4W;
//   1 <= k <= 16; loss (1) fp32.
//
// The TPU kernel sums all heads from one packed read; here one launch is
// one head, and the caller adds the heads in head order (all heads from one
// packed read is queued with the redesign of K3/K4, which share the shape).
//
// Precision: fp32 operands and products, full-precision logf/log1pf, as K4.
//
// What bounds it on an H100 SXM: at the training batch (B = 800, m_pad =
// 1,001,472) and k = 8 it does 2 (k + 1) B m_pad = 14.42 GFLOP (the k FMAs
// of raw and the two logarithms, each counted as one operation), 0.215 ms at
// the 67 TFLOP/s of the fp32 CUDA cores, and reads 200.3 MB of packed rows
// and 32.0 MB of P, 0.069 ms at 3.35 TB/s: operations bound it. Over the
// K = 2..10 sweep (9 launches, sum k = 54) it is 100.9 GFLOP, 1.507 ms.
// Design, K4's layout without its dq and dP:
//   * a block owns a contiguous range of SNP tiles; the 32 lanes of a warp
//     split a tile's SNPs, S = 32/KT consecutive SNPs a lane (KT: k rounded
//     up to 4, 8 or 16), and hold their P in registers while the warp walks
//     its batch rows (row b belongs to warp b % 8), so P is read once;
//   * q is staged in shared memory, 8192/KT rows at a time, and read as
//     broadcast float4s; the next row's packed word is prefetched while a
//     row computes;
//   * each lane sums its terms in a register; then a warp shuffle sum, the
//     block's 8 warps in order, and a second kernel that adds the per-block
//     partials in block order: deterministic, no atomics;
//   * K7, the indexed form (the JAX package's ops/fused_step.py:560-595):
//     with blk_idx, batch row r reads resident row blk_idx[r / blk] * blk +
//     r % blk in place, staged in shared memory beside q (batch_row,
//     unpack.cuh); the gathered form stages r itself. The same arithmetic in
//     the same order, so the two agree bit for bit.
//
// Offsets are 64-bit: k m_pad and rows W pass 2^31 at biobank sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bce.cuh"
#include "unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Per KT (k rounded up to 4, 8 or 16): SNPs a lane owns in a tile, the
// tile's width, and the batch rows staged at a time.
template <int KT>
struct Geom {
  static constexpr int S = 32 / KT;
  static constexpr int kTile = 32 * S;
  static constexpr int kRows = 8192 / KT;
};

// Shared memory: q [kRows][KT], then row_w [kRows] and the packed row of
// each batch row [kRows] (int32).
template <int KT>
size_t smem_bytes() {
  return (size_t)Geom<KT>::kRows * (KT + 2) * sizeof(float);
}

template <int KT, bool MASKED, bool NO_MISSING>
__global__ void __launch_bounds__(kThreads, 2)
bce_sum_kernel(const uint32_t* __restrict__ packed,
               const float* __restrict__ q, const float* __restrict__ P,
               const float* __restrict__ col_mask,
               const float* __restrict__ row_w,
               const int32_t* __restrict__ blk_idx, int blk,
               float* __restrict__ loss_part, int64_t B, int64_t W4, int k,
               int64_t n_tiles) {
  constexpr int S = Geom<KT>::S;
  constexpr int kTile = Geom<KT>::kTile;
  constexpr int kRows = Geom<KT>::kRows;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);      // [kRows][KT]
  float* srw = sq + kRows * KT;                     // [kRows]
  int* srow = reinterpret_cast<int*>(srw + kRows);  // [kRows]
  __shared__ float swarp[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t m_pad = W4 * 16;
  const int64_t t0 = n_tiles * blockIdx.x / gridDim.x;
  const int64_t t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  float lane_loss = 0.f;

  for (int64_t r0 = 0; r0 < B; r0 += kRows) {
    const int rows = (int)(B - r0 < kRows ? B - r0 : kRows);
    __syncthreads();  // every warp is done with the previous rows
    for (int i = threadIdx.x; i < rows * KT; i += kThreads) {
      const int b = i / KT, j = i % KT;
      sq[i] = j < k ? q[(r0 + b) * k + j] : 0.f;
    }
    for (int b = threadIdx.x; b < rows; b += kThreads) {
      if (MASKED) srw[b] = row_w[r0 + b];
      srow[b] = (int)batch_row(blk_idx, blk, r0 + b);
    }
    __syncthreads();

    for (int64_t t = t0; t < t1; ++t) {
      const int64_t s0 = t * kTile + lane * S;  // this lane's first SNP
      const int64_t w = s0 >> 4;                // the u32 word holding them
      const int shift = (int)(s0 & 15) * 2;
      const bool w_ok = w < W4;

      float p[KT][S], cm[S];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int s = 0; s < S; ++s)
          p[j][s] = (j < k && s0 + s < m_pad) ? __ldg(P + j * m_pad + s0 + s)
                                              : 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s)
        cm[s] = (MASKED && s0 + s < m_pad) ? __ldg(col_mask + s0 + s) : 0.f;

      uint32_t u_next = (warp < rows && w_ok)
                            ? __ldg(packed + (int64_t)srow[warp] * W4 + w)
                            : 0u;
      for (int b = warp; b < rows; b += kWarps) {
        uint32_t u = u_next;
        const int bn = b + kWarps;
        u_next = (bn < rows && w_ok)
                     ? __ldg(packed + (int64_t)srow[bn] * W4 + w) : 0u;
        if (!NO_MISSING) u = unpack_word(u);
        u >>= shift;

        float qb[KT];
        const float4* q4 = reinterpret_cast<const float4*>(sq + b * KT);
#pragma unroll
        for (int i = 0; i < KT / 4; ++i) {
          const float4 v = q4[i];
          qb[4 * i + 0] = v.x;
          qb[4 * i + 1] = v.y;
          qb[4 * i + 2] = v.z;
          qb[4 * i + 3] = v.w;
        }
        const float rw = MASKED ? srw[b] : 1.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float x = 0.5f * (float)((u >> (2 * s)) & 3u);
          float raw = 0.f;
#pragma unroll
          for (int j = 0; j < KT; ++j) raw = fmaf(qb[j], p[j][s], raw);
          const float rec = fminf(fmaxf(raw, 0.f), 1.f);
          float e = bce_elem(rec, x);
          if (MASKED) e *= cm[s] * rw;
          lane_loss += e;
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lane_loss += __shfl_xor_sync(0xffffffffu, lane_loss, off);
  if (lane == 0) swarp[warp] = lane_loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += swarp[wi];
    loss_part[blockIdx.x] = s;
  }
}

// *loss = the per-block partials summed in block order, by one thread.
__global__ void bce_sum_reduce_kernel(const float* __restrict__ loss_part,
                                      int n_blocks, float* __restrict__ loss) {
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += loss_part[b];
  *loss = s;
}

template <int KT, bool MASKED, bool NO_MISSING>
cudaError_t launch(const uint32_t* packed, const float* q, const float* P,
                   const float* col_mask, const float* row_w,
                   const int32_t* blk_idx, int blk, float* loss,
                   float* loss_part, int64_t B, int64_t W4, int k,
                   int n_blocks, cudaStream_t stream) {
  auto kernel = bce_sum_kernel<KT, MASKED, NO_MISSING>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<KT>());
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (W4 * 16 + Geom<KT>::kTile - 1) / Geom<KT>::kTile;
  kernel<<<n_blocks, kThreads, smem_bytes<KT>(), stream>>>(
      packed, q, P, col_mask, row_w, blk_idx, blk, loss_part, B, W4, k,
      n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bce_sum_reduce_kernel<<<1, 1, 0, stream>>>(loss_part, n_blocks, loss);
  return cudaGetLastError();
}

template <int KT>
cudaError_t dispatch(const uint32_t* packed, const float* q, const float* P,
                     const float* col_mask, const float* row_w,
                     const int32_t* blk_idx, int blk, float* loss,
                     float* loss_part, int64_t B, int64_t W4, int k,
                     int n_blocks, int masked, int no_missing,
                     cudaStream_t s) {
#define NA_BCE_SUM_LAUNCH(M, N)                                              \
  launch<KT, M, N>(packed, q, P, col_mask, row_w, blk_idx, blk, loss,       \
                   loss_part, B, W4, k, n_blocks, s)
  switch ((masked ? 2 : 0) | (no_missing ? 1 : 0)) {
    case 0: return NA_BCE_SUM_LAUNCH(false, false);
    case 1: return NA_BCE_SUM_LAUNCH(false, true);
    case 2: return NA_BCE_SUM_LAUNCH(true, false);
    default: return NA_BCE_SUM_LAUNCH(true, true);
  }
#undef NA_BCE_SUM_LAUNCH
}

}  // namespace

extern "C" {

// SNP tiles of the plane for k (the most blocks that get work).
long long na_bce_sum_tiles(long long W, int k) {
  const long long m_pad = W * 4;
  const int tile = k <= 4 ? Geom<4>::kTile
                          : (k <= 8 ? Geom<8>::kTile : Geom<16>::kTile);
  return (m_pad + tile - 1) / tile;
}

// packed: (rows, W) uint8, W % 4 == 0, 4-byte aligned: the batch itself
// (blk_idx null, rows = B) or the resident rows that the (B / blk,) int32
// blk_idx indexes (K7); q (B, k); P (k, 4W); col_mask (4W) and row_w (B),
// read only when masked; loss (1) written; loss_part (n_blocks) scratch. All
// fp32 and contiguous; 1 <= k <= 16, B >= 1. Returns the cudaError_t of the
// launches (0 = cudaSuccess).
int na_bce_sum(const void* packed, const void* q, const void* P,
               const void* col_mask, const void* row_w, void* loss,
               void* loss_part, long long B, long long W, int k, int n_blocks,
               int masked, int no_missing, const void* blk_idx, int blk,
               void* stream) {
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  const float* qf = static_cast<const float*>(q);
  const float* Pf = static_cast<const float*>(P);
  const float* cm = static_cast<const float*>(col_mask);
  const float* rw = static_cast<const float*>(row_w);
  const int32_t* bi = static_cast<const int32_t*>(blk_idx);
  float* lf = static_cast<float*>(loss);
  float* lpart = static_cast<float*>(loss_part);
  const int64_t W4 = W / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 16 || n_blocks < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (bi != nullptr && (blk < 1 || B % blk)) return (int)cudaErrorInvalidValue;
  if (k <= 4)
    return dispatch<4>(pk, qf, Pf, cm, rw, bi, blk, lf, lpart, B, W4, k,
                       n_blocks, masked, no_missing, s);
  if (k <= 8)
    return dispatch<8>(pk, qf, Pf, cm, rw, bi, blk, lf, lpart, B, W4, k,
                       n_blocks, masked, no_missing, s);
  return dispatch<16>(pk, qf, Pf, cm, rw, bi, blk, lf, lpart, B, W4, k,
                      n_blocks, masked, no_missing, s);
}

}  // extern "C"
