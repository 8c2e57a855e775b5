// xv: Xp = X @ V straight from 2-bit packed genotype rows, on Hopper's int8
// tensor cores.
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
// Precision. The code g in {0, 1, 2} is an exact int8. V is cut per 512-SNP
// chunk and column d into a power-of-two scale and three int8 pieces: e is
// the smallest integer with amax 2^-e <= 127 2^16 (amax = max |V| over the
// chunk's column; at least -100, and 0 for a zero column), v = rint(V 2^-e)
// (an exact scaling and one rounding, |v - V 2^-e| <= 1/2, so at most
// amax 2^-23 an entry, the size of fp32 rounding), and v = lo + 256 mid +
// 65536 hi with each piece in [-128, 127]. Over one chunk each piece's sum
// of products, |sum g piece| <= 2 128 512 < 2^18, is exact in the int32
// accumulator of mma.sync.m16n8k32 .s8; at the end of the chunk the three
// fold exactly in int64 to t = sum g v, which rounds once to fp32 and
// scales by 2^e (exact) into the row's fp32 running sum, in chunk order.
// The sum is halved once (exact), and the blocks' partials are summed in
// block order. So the result is deterministic, the gathered and the indexed
// forms agree bit for bit, and tests/test_torch_port_xv_mma.py reproduces
// it on the CPU bit for bit. The TPU kernel fed V to its matrix unit in
// bf16 (ops/fused.py:250 _dot_in), which keeps 8 bits.
//
// What bounds it on an H100 SXM: at the training batch (B = 800, m_pad =
// 1,001,472, D = 8) it must read 200.3 MB of packed rows and 32 MB of V,
// 0.069 ms at 3.35 TB/s; its 3 x 12.8 G int8 products take 0.019 ms at the
// 1,979 TOP/s of the int8 tensor cores. So it is bound by bytes, and the
// design keeps the instructions per byte low and each byte read once:
//   * a block owns a contiguous range of 512-SNP chunks and every row of
//     the launch (about 2 blocks an SM; a second tiny kernel sums the
//     blocks' (n_split, B, D) partials in a fixed order, with no atomics):
//     V is read from device memory once, and cut into pieces once;
//   * per chunk the block stages V's pieces in shared memory in B-fragment
//     order (a lane's two registers of a k-step and piece adjacent: one
//     conflict-free 64-bit load), from V values loaded into registers
//     during the previous chunk; the scale needs the chunk's amax per
//     column, one barrier, and a second makes the pieces visible;
//   * warp w takes the 16-row tiles w, w + 8, ...; lane 4g + t loads words
//     8t .. 8t + 7 of the chunk in rows g and g + 8 (two 16-byte loads a
//     row; the 4 lanes of a row cover its 128 bytes), prefetched one tile
//     ahead. The missing -> 0 mask costs 5 integer ops a word (compiled out
//     under NO_MISSING). The k index of a k-step is permuted so that the
//     slice (u >> 2j) & 0x03030303 of a word is an A register as it
//     stands: its byte i is SNP 4i + j of the word. Step s takes slice
//     s & 3 of the lane's words 2(s >> 2) (k 4t..4t+3) and 2(s >> 2) + 1
//     (k 16+4t..), and V's pieces are staged under the same map;
//   * running sums (rows x 8, 16 or 32 columns, fp32) live in shared
//     memory, each row's owned by one warp: race-free and in chunk order.
//     A batch with more rows than kMaxSums / columns goes in several
//     launches by rows (rows are independent in xv);
//   * K7, the indexed form (the JAX package's ops/fused_step.py:560-595):
//     with blk_idx, batch row r is resident row blk_idx[r / blk] * blk +
//     r % blk, read in place instead of from a gathered copy. The indexed
//     instances (INDEXED) stage each row's word offset in shared memory
//     once a launch (batch_row, unpack.cuh). Both forms run the same
//     arithmetic on the same rows, so they agree bit for bit.
// No TMA, wgmma or warp specialisation: plain loads, prefetched into
// registers.
//
// Offsets are 64-bit: B*W passes 2^31 at biobank N.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"
#include "unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkWords = 32;               // u32 words of a row per chunk
constexpr int kChunkSnps = kChunkWords * 16;  // 512 SNPs
constexpr int kSteps = kChunkSnps / 32;       // k-steps of 32 SNPs
constexpr int kPieces = 3;                    // lo, mid, hi
constexpr int kMaxSums = 8192;                // running sums a launch, floats
constexpr uint32_t kSlice = 0x03030303u;

// Columns of the n-tiles (8 each) of a width D <= 32.
template <int NT>
struct Geom {
  static constexpr int Dp = 8 * NT;
  static constexpr int kRows = kMaxSums / Dp;  // rows of one launch
  static constexpr int kPieceWords = kSteps * NT * kPieces * 32 * 2;
};

// Bytes of dynamic shared memory: pieces [kSteps][NT][kPieces][32] uint2,
// running sums [rows16][Dp], amax [kWarps][Dp], scales [Dp], and (INDEXED)
// row offsets [rows16] int64; every part a multiple of 8 bytes.
template <int NT, bool INDEXED>
size_t smem_bytes(int rows16) {
  constexpr int Dp = Geom<NT>::Dp;
  return sizeof(uint32_t) * Geom<NT>::kPieceWords +
         sizeof(float) * ((size_t)rows16 * Dp + kWarps * Dp + Dp) +
         (INDEXED ? sizeof(int64_t) * rows16 : 0);
}

template <int NT, bool NO_MISSING, bool INDEXED>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
xv_mma_kernel(const uint32_t* __restrict__ packed,
              const float* __restrict__ V, float* __restrict__ partial,
              const int32_t* __restrict__ blk_idx, int blk, int64_t B,
              int64_t r0, int rows, int64_t W4, int D, int64_t n_chunks,
              int n_split, int vec16) {
  constexpr int Dp = Geom<NT>::Dp;
  extern __shared__ uint4 smem[];
  uint2* pieces = reinterpret_cast<uint2*>(smem);
  const int rows16 = (rows + 15) & ~15;
  float* sums = reinterpret_cast<float*>(pieces + Geom<NT>::kPieceWords / 2);
  float* red = sums + rows16 * Dp;
  float* scale = red + kWarps * Dp;
  int64_t* row_off = reinterpret_cast<int64_t*>(scale + Dp);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hb = warp & 1, sj = warp >> 1;  // staging: register, slice
  const int split = blockIdx.x;
  const int64_t c0 = n_chunks * split / n_split;
  const int64_t c1 = n_chunks * (split + 1) / n_split;
  const int n_tiles = rows16 >> 4;
  const int64_t m_pad = W4 * 16;

  for (int i = threadIdx.x; i < rows16 * Dp; i += kThreads) sums[i] = 0.f;
  if constexpr (INDEXED) {
    for (int i = threadIdx.x; i < rows16; i += kThreads)
      row_off[i] = i < rows ? batch_row(blk_idx, blk, r0 + i) * W4 : 0;
  }
  __syncthreads();

  // The lane's words 8t .. 8t + 7 of chunk c in rows g and g + 8 of tile
  // tl (zeros past the launch's rows, the row's words, or the block's
  // chunks): u[0..7] row g, u[8..15] row g + 8.
  auto load_tile = [&](uint32_t (&u)[16], int tl, int64_t c) {
    const int64_t w0 = c * kChunkWords + 8 * t;
    const bool whole = vec16 && (c + 1) * kChunkWords <= W4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl * 16 + g + 8 * h;
      if (c < c1 && row < rows) {
        const uint32_t* p =
            (INDEXED ? packed + row_off[row] : packed + (r0 + row) * W4) + w0;
        if (whole) {
          const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
          const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
          u[8 * h + 0] = a.x; u[8 * h + 1] = a.y;
          u[8 * h + 2] = a.z; u[8 * h + 3] = a.w;
          u[8 * h + 4] = b.x; u[8 * h + 5] = b.y;
          u[8 * h + 6] = b.z; u[8 * h + 7] = b.w;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            u[8 * h + k] = w0 + k < W4 ? __ldg(p + k) : 0u;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) u[8 * h + k] = 0u;
      }
    }
  };

  // Staging: thread (lane 4g + t, warp 2 sj + hb) takes, for k = 0..3 and
  // each n-tile nt, the SNPs 16 (8t + 2k + hb) + 4i + sj (i = 0..3) of
  // column 8 nt + g: register hb of lane 4g + t at k-step 4k + sj, byte i.
  float vv[4][NT][4];
  auto load_v = [&](int64_t c) {
    const int64_t s0 = c * kChunkSnps + 16 * (8 * t + hb) + sj;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t s = s0 + 32 * k + 4 * i;
          const int col = 8 * nt + g;
          vv[k][nt][i] = c < c1 && s < m_pad && col < D
                             ? __ldg(V + s * D + col) : 0.f;
        }
  };

  // amax per column over the chunk (the thread's values, the 4 lanes of a
  // column, the 8 warps), then the pieces into shared memory.
  auto stage = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float m = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) m = fmaxf(m, fabsf(vv[k][nt][i]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[warp * Dp + 8 * nt + g] = m;
    }
    __syncthreads();  // every warp's amax, and every warp done with the
                      // previous chunk's pieces
    uint32_t* pw = reinterpret_cast<uint32_t*>(pieces);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + g;
      float amax = red[col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w * Dp + col]);
      const int e = scale_exp(amax);
      if (warp == 0 && t == 0) scale[col] = exp2i(e);
      const float inv = exp2i(-e);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t w[kPieces] = {0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int lo, mid, hi;
          cut(__float2int_rn(vv[k][nt][i] * inv), lo, mid, hi);
          w[0] |= (uint32_t)(lo & 0xff) << (8 * i);
          w[1] |= (uint32_t)(mid & 0xff) << (8 * i);
          w[2] |= (uint32_t)(hi & 0xff) << (8 * i);
        }
        const int s = 4 * k + sj;
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          pw[(((s * NT + nt) * kPieces + p) * 32 + lane) * 2 + hb] = w[p];
      }
    }
  };

  // One tile's 16 k-steps x 3 pieces x NT n-tiles of mma over the chunk,
  // folded into the running sums of rows tl*16 + g and + 8, columns
  // 8 nt + 2t, + 1.
  auto compute = [&](uint32_t (&u)[16], int tl, const float (&sc)[NT][2]) {
    if (!NO_MISSING) {
#pragma unroll
      for (int k = 0; k < 16; ++k) u[k] = unpack_word(u[k]);
    }
    int32_t acc[NT][kPieces][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][p][r] = 0;
    const uint2* pb = pieces + lane;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int wl = 2 * (s >> 2), j = 2 * (s & 3);
      const uint32_t a0 = (u[wl] >> j) & kSlice;      // row g, k 4t..
      const uint32_t a1 = (u[8 + wl] >> j) & kSlice;  // row g + 8
      const uint32_t a2 = (u[wl + 1] >> j) & kSlice;  // row g, k 16+4t..
      const uint32_t a3 = (u[9 + wl] >> j) & kSlice;  // row g + 8
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          mma_s8(acc[nt][p], a0, a1, a2, a3,
                 pb[((s * NT + nt) * kPieces + p) * 32]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* dst = reinterpret_cast<float2*>(
            sums + (tl * 16 + g + 8 * h) * Dp + 8 * nt + 2 * t);
        float2 v = *dst;
        v.x += __fmul_rn(fold(acc[nt][2][2 * h], acc[nt][1][2 * h],
                              acc[nt][0][2 * h]), sc[nt][0]);
        v.y += __fmul_rn(fold(acc[nt][2][2 * h + 1], acc[nt][1][2 * h + 1],
                              acc[nt][0][2 * h + 1]), sc[nt][1]);
        *dst = v;
      }
  };

  uint32_t nxt[16];
  load_v(c0);
  load_tile(nxt, warp, c0);
  for (int64_t c = c0; c < c1; ++c) {
    stage();
    load_v(c + 1);  // lands while this chunk computes
    __syncthreads();  // the pieces and scales of chunk c
    float sc[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = scale[8 * nt + 2 * t];
      sc[nt][1] = scale[8 * nt + 2 * t + 1];
    }
    for (int tl = warp; tl < n_tiles; tl += kWarps) {
      uint32_t u[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) u[k] = nxt[k];
      // prefetch: the warp's next tile, or its first of the next chunk
      const bool wrap = tl + kWarps >= n_tiles;
      load_tile(nxt, wrap ? warp : tl + kWarps, wrap ? c + 1 : c);
      compute(u, tl, sc);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    partial[((int64_t)split * B + r0 + r) * D + d] = 0.5f * sums[r * Dp + d];
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

template <int NT, bool NO_MISSING, bool INDEXED>
cudaError_t launch(const uint32_t* packed, const float* V, float* partial,
                   float* out, const int32_t* blk_idx, int blk, int64_t B,
                   int64_t W4, int D, int n_split, cudaStream_t stream) {
  constexpr int kRows = Geom<NT>::kRows;
  auto kernel = xv_mma_kernel<NT, NO_MISSING, INDEXED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<NT, INDEXED>(kRows));
  if (err != cudaSuccess) return err;
  const int64_t n_chunks = (W4 + kChunkWords - 1) / kChunkWords;
  const int vec16 =
      W4 % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  for (int64_t r0 = 0; r0 < B; r0 += kRows) {
    const int rows = (int)(B - r0 < kRows ? B - r0 : kRows);
    kernel<<<(unsigned)n_split, kThreads,
             smem_bytes<NT, INDEXED>((rows + 15) & ~15), stream>>>(
        packed, V, partial, blk_idx, blk, B, r0, rows, W4, D, n_chunks,
        n_split, vec16);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t n = B * D;
  xv_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, out, n, n_split);
  return cudaGetLastError();
}

template <int NT>
cudaError_t dispatch_missing(const uint32_t* packed, const float* V,
                             float* partial, float* out,
                             const int32_t* blk_idx, int blk, int64_t B,
                             int64_t W4, int D, int n_split, int no_missing,
                             cudaStream_t stream) {
#define NA_XV_LAUNCH(N, I) \
  launch<NT, N, I>(packed, V, partial, out, blk_idx, blk, B, W4, D, n_split, \
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

// Rows of the batch one launch covers (its running sums fill kMaxSums
// floats); a larger batch takes several launches.
int na_xv_rows_per_block(int D) {
  if (D <= 8) return Geom<1>::kRows;
  if (D <= 16) return Geom<2>::kRows;
  return Geom<4>::kRows;
}

// SNP chunks of 512 a row holds: the most splits that get work.
long long na_xv_chunks(long long W) {
  const long long W4 = W / 4;
  return (W4 + kChunkWords - 1) / kChunkWords;
}

// packed: (rows, W) uint8, W % 4 == 0, 4-byte aligned: the batch itself
// (blk_idx null, rows = B) or the resident rows that the (B / blk,) int32
// blk_idx indexes (K7); V: (4W, D) fp32; partial: (n_split, B, D) fp32
// scratch, n_split <= na_xv_chunks(W); out: (B, D) fp32. Returns the
// cudaError_t of the launches (0 = cudaSuccess). 1 <= D <= 32.
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
  if (D < 1 || n_split < 1 || n_split > na_xv_chunks(W))
    return (int)cudaErrorInvalidValue;
  if (D <= 8)
    return dispatch_missing<1>(p, v, part, o, bi, blk, B, W4, D, n_split,
                               no_missing, s);
  if (D <= 16)
    return dispatch_missing<2>(p, v, part, o, bi, blk, B, W4, D, n_split,
                               no_missing, s);
  if (D <= 32)
    return dispatch_missing<4>(p, v, part, o, bi, blk, B, W4, D, n_split,
                               no_missing, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
