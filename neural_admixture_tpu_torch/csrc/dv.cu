// dv: dV = X^T dXp straight from 2-bit packed genotype rows, on Hopper's
// int8 tensor cores.
//
// Replaces the JAX package's Pallas kernel ops/fused_step.py:319 _dvt_kernel
// (through :734 _dv_call, kernel K5): the gradient of the PCA basis V, the
// last of a training step's three packed passes, after the encoder's
// backward has turned dQ into dXp.
//
//   packed (B, W) uint8, row-major, read as little-endian u32 words in
//          natural SNP order (word w holds SNPs 16w .. 16w + 15, byte i of
//          it SNPs 4i .. 4i + 3);
//   dXp    (B, D) fp32, D <= 32;
//   dV     (m_pad, D) fp32 with m_pad = 4W, in natural order (the TPU kernel
//          wrote dV^T for its lane layout; no transpose is needed here),
//          dV[m, d] = sum_b x(b, m) dXp[b, d],
//          x = g/2 for the 2-bit code g, and 0 for code 3 (missing).
//
// Precision. The code g in {0, 1, 2} is an exact int8. dXp is cut per chunk
// of 256 batch rows and column d into a power-of-two scale and four int8
// pieces (mma_s8.cuh): e is the smallest integer with amax 2^-e <= 127 2^24
// (amax = max |dXp| over the chunk's column; at least -100, and 0 for a zero
// column), v = rint(dXp 2^-e) (an exact scaling and one rounding: at most
// amax 2^-31 an entry), v = sum_k p_k 256^k with each piece in [-128, 127].
// Three pieces (amax 2^-23 an entry) are not enough here: the reduction runs
// over batch rows, and a chunk whose scale one large row sets while that
// row's codes are 0 leaves the other rows' sum at 2^-23 of the large one,
// which breaks PERF.md's rule (tests/test_torch_port_dv_mma.py shows both).
// Over one chunk each piece's sum of products, |sum g p| <= 2 128 256 =
// 2^16, is exact in the int32 accumulator of mma.sync.m16n8k32 .s8; at the
// end of the chunk the four fold exactly in int64 to t = sum g v, which
// rounds once to fp32 and scales by 2^e (exact) into the output's fp32
// running sum, in chunk order, in the registers of the one lane that owns
// the output. The sum is halved once (exact) and stored. So the result is
// deterministic, with no atomics, the gathered and the indexed forms agree
// bit for bit, and tests/test_torch_port_dv_mma.py reproduces it on the CPU
// bit for bit. The TPU kernel fed dXp to its matrix unit in bf16.
//
// What bounds it on an H100 SXM: at the training batch (B = 800, m_pad =
// 1,001,472, D = 8) it must read 200.3 MB of packed rows and write 32 MB of
// dV, 0.069 ms at 3.35 TB/s; its 4 x 12.8 G int8 products take 0.026 ms at
// the 1,979 TOP/s of the int8 tensor cores. So it is bound by bytes, and the
// design keeps the instructions per code low and the row stream in flight:
//   * mma: M = 16 SNPs, N = 8 columns of dXp, K = 32 batch rows. Each output
//     (SNP, d) is accumulated whole in one lane's C fragment: no partial
//     sums, no second pass;
//   * persistent blocks of 8 warps (as many an SM as fit, about 2), each
//     over a contiguous range of 512-SNP tiles and every batch row of the
//     launch; a block cuts dXp into pieces once, into shared memory in
//     B-fragment order (one conflict-free 64-bit load a lane, k-step and
//     piece);
//   * the rows stream through a ring of kStages slots, one k-step (32 rows
//     x 128 bytes of the tile) a slot, one 16-byte cp.async a thread (4-byte
//     copies when a row is not 16-byte aligned), across tile boundaries;
//     each slot's 16-byte chunks are XOR-swizzled by row % 8, so that the
//     lanes of one read hit distinct banks;
//   * warp w owns words 4w .. 4w + 3 of the tile (4 m-tiles of 16 SNPs);
//     lane 4g + t takes word 4w + (g & 3), bytes i0 = 2(g >> 2) and i0 + 1:
//     M row g (g + 8) of m-tile j is SNP 4 i0 + j (4 i0 + 4 + j) of that
//     word. K position 16h + 4t + r is batch row 16h + t + 4r of the k-step,
//     so the 4 lanes t of a group read 4 consecutive rows at once. Per
//     k-step a lane reads its word in 8 rows; for each 4 rows, two stages
//     of PRMT (4 in all) make T_i = the 4 rows' byte i for its two bytes,
//     and (T_i >> 2j) & 0x03030303 is then the A register of SNP 4i + j as
//     it stands: 8 PRMT and 16 shift-and-masks feed 4 m-tiles x 4 pieces of
//     mma. The missing -> 0 mask runs on the 4 transposed registers, 5
//     integer ops each (compiled out under NO_MISSING);
//   * a launch takes at most kRowsPerLaunch rows (their pieces fill 64 KB);
//     a larger batch takes several launches by rows, each later one adding
//     into dV in order. D > 8 takes one launch per group of 8 columns;
//   * K7, the indexed form (the JAX package's ops/fused_step.py:560-595):
//     with blk_idx, batch row r is resident row blk_idx[r / blk] * blk +
//     r % blk, read in place instead of from a gathered copy. The indexed
//     instances (INDEXED) stage each row's word offset in shared memory
//     once a launch (batch_row, unpack.cuh). Both forms run the same
//     arithmetic on the same rows, so they agree bit for bit.
// No TMA, wgmma or warp specialisation.
//
// Offsets are 64-bit: B*W and m_pad*D pass 2^31 at biobank sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"
#include "unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileWords = 32;                    // u32 words of a row a tile
constexpr int kTileSnps = kTileWords * 16;        // 512 SNPs
constexpr int kStepRows = 32;                     // batch rows of a k-step
constexpr int kChunkSteps = 8;                    // k-steps of a scale chunk
constexpr int kChunkRows = kStepRows * kChunkSteps;  // 256 rows
constexpr int kPieces = 4;
constexpr int kRowsPerLaunch = 2048;
constexpr int kMaxChunks = kRowsPerLaunch / kChunkRows;
constexpr int kStages = 8;                        // ring slots
constexpr int kSlotWords = kStepRows * kTileWords;  // 4 KB a slot
constexpr uint32_t kSlice = 0x03030303u;

// Bytes of dynamic shared memory for a launch of ``rows`` rows: the ring
// [kStages][kSlotWords] u32, pieces [steps][kPieces][32] uint2, scales and
// their inverses [kMaxChunks][8] fp32, amax partials [kMaxChunks][kWarps][8]
// fp32, and (INDEXED) row offsets [steps * 32] int64.
template <bool INDEXED>
size_t smem_bytes(int rows) {
  const size_t steps = (rows + kStepRows - 1) / kStepRows;
  return sizeof(uint32_t) * kStages * kSlotWords +
         sizeof(uint2) * steps * kPieces * 32 +
         sizeof(float) * (2 * kMaxChunks * 8 + kMaxChunks * kWarps * 8) +
         (INDEXED ? sizeof(int64_t) * steps * kStepRows : 0);
}

// n bytes (16, or 0: zero-fill) from global src to shared dst, async.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool NO_MISSING, bool INDEXED>
__global__ void __launch_bounds__(kThreads, 2)
dv_mma_kernel(const uint32_t* __restrict__ packed,
              const float* __restrict__ dXp,
              const int32_t* __restrict__ blk_idx, int blk,
              float* __restrict__ dV, int64_t r0, int rows, int64_t W4, int D,
              int col0, int64_t n_tiles, int accumulate, int vec16) {
  extern __shared__ uint4 smem[];
  const int steps = (rows + kStepRows - 1) / kStepRows;
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint2* pieces = reinterpret_cast<uint2*>(ring + kStages * kSlotWords);
  float* scale = reinterpret_cast<float*>(pieces + steps * kPieces * 32);
  float* inv = scale + kMaxChunks * 8;
  float* red = inv + kMaxChunks * 8;
  int64_t* row_off = reinterpret_cast<int64_t*>(red + kMaxChunks * kWarps * 8);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m_pad = W4 * 16;
  const int64_t t0 = n_tiles * blockIdx.x / gridDim.x;
  const int64_t t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  const int n_items = (int)(t1 - t0) * steps;

  if constexpr (INDEXED) {
    for (int i = tid; i < steps * kStepRows; i += kThreads)
      row_off[i] = i < rows ? batch_row(blk_idx, blk, r0 + i) * W4 : 0;
    __syncthreads();
  }

  // Copy thread (row = tid >> 3, chunk c = tid & 7): words 4c .. 4c + 3 of
  // the tile in row k 32 + row of the launch, into the swizzled chunk;
  // zeros past the rows or the row's words.
  const int cp_row = tid >> 3, cp_c = tid & 7;
  const int cp_dst = cp_row * kTileWords + 4 * (cp_c ^ (cp_row & 7));
  int64_t is_tile = t0;
  int is_step = 0;
  auto fetch = [&](int item) {
    uint32_t* dst = ring + (item % kStages) * kSlotWords + cp_dst;
    const int b = is_step * kStepRows + cp_row;
    const int64_t w0 = is_tile * kTileWords + 4 * cp_c;
    const bool live = b < rows;
    const int64_t base =
        live ? (INDEXED ? row_off[b] : (r0 + b) * W4) + w0 : 0;
    if (vec16) {  // W4 % 4 == 0: a chunk is whole or past the row
      const bool ok = live && w0 < W4;
      cp_async16(dst, ok ? packed + base : packed, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = live && w0 + k < W4;
        cp_async4(dst + k, ok ? packed + base + k : packed, ok ? 4 : 0);
      }
    }
    if (++is_step == steps) {
      is_step = 0;
      ++is_tile;
    }
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) fetch(s);
    cp_async_commit();
  }

  // The cut of dXp (columns col0 .. col0 + 7), while the first slots land.
  // amax per chunk and column: thread (part = tid >> 3, column tid & 7)
  // over rows part + 32 k of the chunk, then the lanes of a column, then
  // the warps.
  {
    const int col = tid & 7, part = tid >> 3;
    const bool col_ok = col0 + col < D;
    for (int c = 0; c < chunks; ++c) {
      float m = 0.f;
#pragma unroll
      for (int k = 0; k < kChunkRows / 32; ++k) {
        const int b = c * kChunkRows + part + 32 * k;
        if (b < rows && col_ok)
          m = fmaxf(m, fabsf(__ldg(dXp + (r0 + b) * D + col0 + col)));
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (lane < 8) red[(c * kWarps + warp) * 8 + col] = m;
    }
    __syncthreads();
    if (tid < chunks * 8) {
      const int c = tid >> 3;
      float m = red[c * kWarps * 8 + col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        m = fmaxf(m, red[(c * kWarps + w) * 8 + col]);
      const int e = scale_exp<kPieces>(m);
      scale[tid] = exp2i(e);
      inv[tid] = exp2i(-e);
    }
    __syncthreads();
    // Register h of lane (gg, tt) at k-step ks, piece k: byte r is the
    // piece of row ks 32 + 16h + tt + 4r, column col0 + gg.
    uint32_t* pw = reinterpret_cast<uint32_t*>(pieces);
    for (int idx = tid; idx < steps * 64; idx += kThreads) {
      const int ks = idx >> 6, ln = (idx >> 1) & 31, h = idx & 1;
      const int gg = ln >> 2, tt = ln & 3;
      const bool ok = col0 + gg < D;
      uint32_t w[kPieces] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = ks * kStepRows + 16 * h + tt + 4 * r;
        const float v =
            b < rows && ok ? __ldg(dXp + (r0 + b) * D + col0 + gg) : 0.f;
        int p[kPieces];
        cut(__float2int_rn(v * inv[(b / kChunkRows) * 8 + gg]), p);
#pragma unroll
        for (int k = 0; k < kPieces; ++k)
          w[k] |= (uint32_t)(p[k] & 0xff) << (8 * r);
      }
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        pw[((ks * kPieces + k) * 32 + ln) * 2 + h] = w[k];
    }
  }

  // The lane's word 4 warp + (g & 3) of slot row 16h + t + 4r sits at
  // (t + 16h + 4r) 32 + 4 (warp ^ ((t + 4r) & 7)) + (g & 3): two bases, one
  // for even r and one for odd, and constant offsets.
  const int rd_even = t * kTileWords + 4 * (warp ^ t) + (g & 3);
  const int rd_odd = t * kTileWords + 4 * (warp ^ (t + 4)) + (g & 3);
  // PRMT selector: [u0.byte i0, u1.byte i0, u0.byte i1, u1.byte i1]
  const uint32_t sel = (g >> 2) ? 0x7362u : 0x5140u;

  int32_t acc[4][kPieces][4];
  float sums[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sums[j][q] = 0.f;
#pragma unroll
      for (int k = 0; k < kPieces; ++k) acc[j][k][q] = 0;
    }

  int64_t tile = t0;
  int ks = 0;
#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of item it
    __syncthreads();  // everyone's copies of it; everyone done with it - 1
    if (it + kStages - 1 < n_items) fetch(it + kStages - 1);
    cp_async_commit();

    const uint32_t* slot = ring + (it % kStages) * kSlotWords;
    uint32_t T[2][2];  // [h][byte i0, i1] of the 4 rows 16h + t + 4r
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t u0 = slot[rd_even + (16 * h + 0) * kTileWords];
      const uint32_t u1 = slot[rd_odd + (16 * h + 4) * kTileWords];
      const uint32_t u2 = slot[rd_even + (16 * h + 8) * kTileWords];
      const uint32_t u3 = slot[rd_odd + (16 * h + 12) * kTileWords];
      const uint32_t p01 = __byte_perm(u0, u1, sel);
      const uint32_t p23 = __byte_perm(u2, u3, sel);
      T[h][0] = __byte_perm(p01, p23, 0x5410);
      T[h][1] = __byte_perm(p01, p23, 0x7632);
      if (!NO_MISSING) {
        T[h][0] = unpack_word(T[h][0]);
        T[h][1] = unpack_word(T[h][1]);
      }
    }
    uint2 bf[kPieces];
    const uint2* pb = pieces + ks * kPieces * 32 + lane;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) bf[k] = pb[k * 32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a0 = (T[0][0] >> (2 * j)) & kSlice;  // row g, k 4t..
      const uint32_t a1 = (T[0][1] >> (2 * j)) & kSlice;  // row g + 8
      const uint32_t a2 = (T[1][0] >> (2 * j)) & kSlice;  // row g, k 16+4t..
      const uint32_t a3 = (T[1][1] >> (2 * j)) & kSlice;  // row g + 8
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        mma_s8(acc[j][k], a0, a1, a2, a3, bf[k]);
    }

    const bool last = ks == steps - 1;
    if ((ks & (kChunkSteps - 1)) == kChunkSteps - 1 || last) {
      // the chunk's fold: columns col0 + 2t (c0, c2) and + 1 (c1, c3)
      const int c = ks / kChunkSteps;
      const float s0 = scale[c * 8 + 2 * t], s1 = scale[c * 8 + 2 * t + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int32_t a[kPieces] = {acc[j][0][q], acc[j][1][q],
                                      acc[j][2][q], acc[j][3][q]};
          sums[j][q] =
              __fadd_rn(sums[j][q], __fmul_rn(fold(a), q & 1 ? s1 : s0));
#pragma unroll
          for (int k = 0; k < kPieces; ++k) acc[j][k][q] = 0;
        }
    }
    if (last) {
      // M row g + 8 hh of m-tile j: SNP 4 (2 (g >> 2) + hh) + j of word
      // 4 warp + (g & 3); columns col0 + 2t, + 1
      const int col = col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int64_t s = tile * kTileSnps + 16 * (4 * warp + (g & 3)) +
                            4 * (2 * (g >> 2) + hh) + j;
          if (s < m_pad && col < D) {
            float* dst = dV + s * D + col;
            float v0 = 0.5f * sums[j][2 * hh], v1 = 0.5f * sums[j][2 * hh + 1];
            if (col + 1 < D) {
              if (accumulate) {
                v0 = __fadd_rn(dst[0], v0);
                v1 = __fadd_rn(dst[1], v1);
              }
              if ((D & 1) == 0) {
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                dst[0] = v0;
                dst[1] = v1;
              }
            } else {
              dst[0] = accumulate ? __fadd_rn(dst[0], v0) : v0;
            }
          }
          sums[j][2 * hh] = 0.f;
          sums[j][2 * hh + 1] = 0.f;
        }
      ks = 0;
      ++tile;
    } else {
      ++ks;
    }
  }
}

template <bool NO_MISSING, bool INDEXED>
cudaError_t launch(const uint32_t* packed, const float* dXp,
                   const int32_t* blk_idx, int blk, float* dV, int64_t B,
                   int64_t W4, int D, cudaStream_t stream) {
  auto kernel = dv_mma_kernel<NO_MISSING, INDEXED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<INDEXED>(kRowsPerLaunch));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (W4 + kTileWords - 1) / kTileWords;
  const int vec16 =
      W4 % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  for (int64_t r0 = 0; r0 < B; r0 += kRowsPerLaunch) {
    const int rows = (int)(B - r0 < kRowsPerLaunch ? B - r0 : kRowsPerLaunch);
    const size_t smem = smem_bytes<INDEXED>(rows);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
    const unsigned grid = (unsigned)(n_tiles < fit ? n_tiles : fit);
    for (int col0 = 0; col0 < D; col0 += 8) {
      kernel<<<grid, kThreads, smem, stream>>>(
          packed, dXp, blk_idx, blk, dV, r0, rows, W4, D, col0,
          n_tiles, r0 > 0, vec16);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Batch rows of one launch; a larger batch takes several, in order.
int na_dv_rows_per_launch() { return kRowsPerLaunch; }

// packed: (rows, W) uint8, W % 4 == 0, 4-byte aligned: the batch itself
// (blk_idx null, rows = B) or the resident rows that the (B / blk,) int32
// blk_idx indexes (K7); dXp: (B, D) fp32; dV: (4W, D) fp32, every element
// written. Returns the cudaError_t of the launches (0 = cudaSuccess).
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
  if (B < 1 || D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  if (bi != nullptr && (blk < 1 || B % blk)) return (int)cudaErrorInvalidValue;
#define NA_DV_LAUNCH(N, I) launch<N, I>(p, x, bi, blk, out, B, W4, D, s)
  switch ((no_missing ? 2 : 0) | (bi != nullptr ? 1 : 0)) {
    case 0: return (int)NA_DV_LAUNCH(false, false);
    case 1: return (int)NA_DV_LAUNCH(false, true);
    case 2: return (int)NA_DV_LAUNCH(true, false);
    default: return (int)NA_DV_LAUNCH(true, true);
  }
#undef NA_DV_LAUNCH
}

}  // extern "C"
