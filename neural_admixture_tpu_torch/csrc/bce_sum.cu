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
//   loss += -(x max(log rec, -100) + (1-x) max(log1p(-rec), -100))
//   MASKED: each term times col_mask[m] row_w[b].
//
//   packed (rows, W) uint8 as little-endian u32 words, natural SNP order;
//   q (B, k), P (k, m_pad), col_mask (m_pad), row_w (B): fp32; m_pad = 4W;
//   1 <= k <= 16; loss (1) fp32.
//
// The TPU kernel sums all heads from one packed read; here one launch is
// one head, and the caller adds the heads in head order.
//
// What bounds it on an H100 SXM: at the training batch (B = 800, m_pad =
// 1,001,472) and k = 8, raw = q P in 3xTF32 is 3 x 2kB m_pad = 38.5 G TF32
// operations, 0.078 ms at 495 TFLOP/s, and the term's two logarithms, one
// fp32 operation each, 1.6 G, 0.024 ms at 67 TFLOP/s: 0.102 ms; it reads
// 200.3 MB of packed rows and 32.0 MB of P, 0.069 ms at 3.35 TB/s. So
// operations bound it, and what it issues bounds it more tightly still: a
// full-precision logarithm is a software routine of some twenty
// instructions, and the kernel before this design spent two of them, the
// k FMAs of raw, the decode and the clamp on every element: 83 SASS
// instructions an element in its inner loop at k = 8, 2.2 ms, about 89% of
// what the SMs can issue in that time at 1980 MHz. This design issues 43
// (PERF.md, section 6). Design against that:
//   * raw on the tensor cores, as K4 (dq_dp.cu) computes it:
//     mma.sync.m16n8k8 TF32, 3xTF32 (mma_tf32.cuh: q and P split to
//     nearest, exact for values on a 2^-10 grid), a warp computing 16 batch
//     rows x 8 SNPs as q (16 x k) . P (k x 8), k padded to 8 or 16 with
//     zeros (KS head slices of 8); k index t of the fragments is head 2t,
//     t + 4 head 2t + 1.
//     Lane (g, t) holds the elements of rows g and g + 8 at SNPs 2t and
//     2t + 1 of each 8-SNP step (c0..c3), and reads their codes from the two
//     rows' packed words, shifted once by 4t;
//   * one logarithm an element (bce_term, bce.cuh): the target has three
//     values, and each needs one log of one argument, 1 - r, r or
//     r (1 - r), with a Fast2Sum correction that keeps log1p's precision;
//     the log is log_unit (bce.cuh): logf's reduction with a shorter
//     minimax polynomial and without the paths that [0, 1] never takes
//     (16 instructions, logf's 24);
//   * the codes read as bits: code 3 zeroed in a whole word (unpack_word,
//     skipped under NO_MISSING), then each element's two tests (low bit:
//     code 1, high bit: code 2) are one instruction each;
//   * q is split once per launch into shared memory, big and small TF32
//     pieces each in A-fragment order (a lane's four registers of a row
//     group and head slice are one conflict-free 16-byte load), with row_w
//     and each batch row's packed row; the rows of a batch beyond what
//     shared memory holds (cap) are staged in further passes;
//   * work is (chunk, 16-row group) pairs, a chunk NS 8-SNP steps (64 SNPs
//     for KS = 1, 32 for KS = 2: four words or two of each row), in
//     chunk-major order, cut into equal contiguous ranges, one a warp of
//     the whole grid: every warp gets the same work within one row group,
//     and a warp reloads and splits P's B fragments (and col_mask) only
//     when its chunk changes, into shared memory that only the lane that
//     wrote a slot reads (registers would cap the chunk at half the
//     width); the next pair's packed words load while a pair computes;
//   * each lane sums a pair's terms, then adds that to its running sum;
//     then a warp shuffle sum, the block's 8 warps in order, and a second
//     kernel that adds the per-block partials in block order:
//     deterministic, no atomics;
//   * K7, the indexed form (the JAX package's ops/fused_step.py:560-595):
//     with blk_idx, batch row r reads resident row blk_idx[r / blk] * blk +
//     r % blk in place, staged in shared memory (batch_row, unpack.cuh);
//     the gathered form stages r itself. The same arithmetic in the same
//     order, so the two agree bit for bit.
// Packed words past the row's end (the last chunk's tail) and rows past B
// (the last row group's padding) read as code 0 against raw = 0: a term of
// exactly 0.
//
// Offsets are 64-bit: k m_pad and rows W pass 2^31 at biobank sizes; a
// row's words, the chunks and a pass's (chunk, row group) pairs a warp
// count in 32 bits (m_pad < 2^35).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bce.cuh"
#include "mma_tf32.cuh"
#include "unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Shared memory of one block when two share an SM: (228 KB - 2 x 1 KB
// reserved) / 2.
constexpr int kSmemCap = 115712;

// Per KS (8-wide head slices: 1 for k <= 8, 2 for k <= 16): the 8-SNP steps
// of a chunk, its SNPs and u32 words a row, the shared memory of each warp's
// P fragments (uint4 a lane, step and head slice) and col_mask values
// (float2 a lane and step), and the most batch rows one pass stages (a
// multiple of 16).
template <int KS>
struct Geom {
  static constexpr int NS = KS == 1 ? 8 : 4;
  static constexpr int kChunk = 8 * NS;
  static constexpr int NW = kChunk / 16;
  static constexpr int kPBytes = kWarps * NS * KS * 32 * 16;
  static constexpr int kCmBytes = kWarps * NS * 32 * 8;
  static constexpr int kRows =
      (kSmemCap - kPBytes - kCmBytes) / ((16 * KS + 2) * 4) / 16 * 16;
};

// Shared memory: the warps' P fragments [kWarps][NS][KS][32 lanes] and
// col_mask values [kWarps][NS][32 lanes], then q's big and small pieces in
// A-fragment order, [cap/16][KS][32 lanes] uint4 each, row_w [cap] and each
// batch row's packed row [cap] (int32).
template <int KS>
size_t smem_bytes(int cap) {
  return (size_t)Geom<KS>::kPBytes + Geom<KS>::kCmBytes +
         (size_t)(16 * KS + 2) * cap * sizeof(float);
}

template <int KS, bool MASKED, bool NO_MISSING>
__global__ void __launch_bounds__(kThreads, 2)
bce_sum_kernel(const uint32_t* __restrict__ packed,
               const float* __restrict__ q, const float* __restrict__ P,
               const float* __restrict__ col_mask,
               const float* __restrict__ row_w,
               const int32_t* __restrict__ blk_idx, int blk,
               float* __restrict__ loss_part, int64_t B, int64_t W4, int k,
               int cap) {
  using G = Geom<KS>;
  constexpr int NS = G::NS, CH = G::kChunk, NW = G::NW;
  extern __shared__ uint4 smem4[];
  uint4* spf = smem4;                                   // [kWarps][NS][KS][32]
  float2* scm = reinterpret_cast<float2*>(spf + kWarps * NS * KS * 32);
  uint4* sqb = reinterpret_cast<uint4*>(scm + kWarps * NS * 32);
  uint4* sqs = sqb + cap / 16 * KS * 32;                // [cap/16][KS][32]
  float* srw = reinterpret_cast<float*>(sqs + cap / 16 * KS * 32);  // [cap]
  int* srow = reinterpret_cast<int*>(srw + cap);                    // [cap]
  __shared__ float swarp[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fg = lane >> 2, ft = lane & 3;  // g and t of the fragment maps
  const int64_t m_pad = W4 * 16;
  const int n_chunks = (int)((m_pad + CH - 1) / CH);
  const int w4 = (int)W4;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  const int64_t gw = (int64_t)blockIdx.x * kWarps + warp;
  uint4* wpf = spf + warp * NS * KS * 32 + lane;  // this lane's, stride 32
  float2* wcm = scm + warp * NS * 32 + lane;
  float lane_loss = 0.f;

  // P's B fragments of chunk c, split, into this lane's slots: {big b0,
  // big b1, small b0, small b1} of P[8h + 2t + e][s + g] at step s = c CH +
  // 8 st, head slice h; and col_mask at the lane's SNPs s + 2t + e. Steps
  // past m_pad (a multiple of 16) read 0. Only this lane reads them back.
  auto load_p = [&](int c) {
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const int64_t s = (int64_t)c * CH + 8 * st;
      const bool in = s < m_pad;
#pragma unroll
      for (int h = 0; h < KS; ++h) {
        uint32_t b[2], sm[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * h + 2 * ft + e;
          const float v = (in && j < k) ? __ldg(P + j * m_pad + s + fg) : 0.f;
          split(v, b[e], sm[e]);
        }
        wpf[(st * KS + h) * 32] = make_uint4(b[0], b[1], sm[0], sm[1]);
      }
      if (MASKED)
        wcm[st * 32] = in ? make_float2(__ldg(col_mask + s + 2 * ft),
                                        __ldg(col_mask + s + 2 * ft + 1))
                          : make_float2(0.f, 0.f);
    }
  };

  for (int64_t r0 = 0; r0 < B; r0 += cap) {
    const int rows = (int)(B - r0 < cap ? B - r0 : cap);
    const int groups = (rows + 15) / 16;
    __syncthreads();  // every warp is done with the previous rows
    // q split, in A-fragment order: register a of lane 4g + t for head
    // slice h of row group G is q[16 G + g + 8 (a & 1)][8 h + 2 t + a / 2],
    // one 16-byte load a lane.
    uint32_t* qb32 = reinterpret_cast<uint32_t*>(sqb);
    uint32_t* qs32 = reinterpret_cast<uint32_t*>(sqs);
    for (int i = threadIdx.x; i < groups * KS * 128; i += kThreads) {
      const int a = i & 3, ln = (i >> 2) & 31, h = (i >> 7) % KS;
      const int b = i / (KS * 128) * 16 + (ln >> 2) + 8 * (a & 1);
      const int j = 8 * h + 2 * (ln & 3) + (a >> 1);
      const float v = (b < rows && j < k) ? q[(r0 + b) * k + j] : 0.f;
      split(v, qb32[i], qs32[i]);
    }
    for (int b = threadIdx.x; b < groups * 16; b += kThreads) {
      srw[b] = (MASKED && b < rows) ? row_w[r0 + b] : 0.f;
      srow[b] = b < rows ? (int)batch_row(blk_idx, blk, r0 + b) : 0;
    }
    __syncthreads();

    // This warp's (chunk, row group) pairs.
    const int64_t n_items = (int64_t)n_chunks * groups;
    const int64_t i0 = n_items * gw / n_warps;
    const int n_mine = (int)(n_items * (gw + 1) / n_warps - i0);
    if (n_mine == 0) continue;
    // The words of chunk c of the rows of group j: rows g and g + 8, NW
    // words each; 0 past the row's end and for rows past B.
    auto load_words = [&](int c, int j, uint32_t (&ua)[NW],
                          uint32_t (&ub)[NW]) {
      const int ra = 16 * j + fg, rb = ra + 8;
      const int w0 = c * NW;
      const uint32_t* pa = packed + (int64_t)srow[ra] * W4 + w0;
      const uint32_t* pbr = packed + (int64_t)srow[rb] * W4 + w0;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const bool ok = w0 + i < w4;
        ua[i] = (ok && ra < rows) ? __ldg(pa + i) : 0u;
        ub[i] = (ok && rb < rows) ? __ldg(pbr + i) : 0u;
      }
    };
    int c = (int)(i0 / groups);
    int j = (int)(i0 % groups);
    load_p(c);
    uint32_t na[NW], nb[NW];
    load_words(c, j, na, nb);
    for (int it = 0; it < n_mine; ++it) {
      // The codes, code 3 zeroed, shifted so that bits 16 (st & 1) + 2e
      // and + 1 of word st / 2 are this lane's SNP 2t + e of step st: the
      // low bit set for code 1, the high bit for code 2.
      uint32_t ua[NW], ub[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        ua[i] = (NO_MISSING ? na[i] : unpack_word(na[i])) >> (4 * ft);
        ub[i] = (NO_MISSING ? nb[i] : unpack_word(nb[i])) >> (4 * ft);
      }
      const int ra = 16 * j + fg, rb = ra + 8;
      int jn = j + 1, cn = c;
      if (jn == groups) {
        jn = 0;
        ++cn;
      }
      if (it + 1 < n_mine) load_words(cn, jn, na, nb);
      // q's A fragments: heads 8h + 2t (column t) and 8h + 2t + 1 (t + 4).
      uint32_t qb[KS][4], qs[KS][4];
#pragma unroll
      for (int h = 0; h < KS; ++h) {
        const uint4 vb = sqb[(j * KS + h) * 32 + lane];
        const uint4 vs = sqs[(j * KS + h) * 32 + lane];
        qb[h][0] = vb.x;
        qb[h][1] = vb.y;
        qb[h][2] = vb.z;
        qb[h][3] = vb.w;
        qs[h][0] = vs.x;
        qs[h][1] = vs.y;
        qs[h][2] = vs.z;
        qs[h][3] = vs.w;
      }
      const float rwa = MASKED ? srw[ra] : 1.f, rwb = MASKED ? srw[rb] : 1.f;

      // raw of each step: the three products of 3xTF32 in turn over the
      // head slices, small ones first, in one accumulator; then the terms
      // of c0..c3: row ra (c0, c1) or rb, SNP s + 2t (c0, c2) or s + 2t + 1.
      // Unmasked, acc + w t is one FMA: w t is exact (w = 1 or 1/2).
      float acc = 0.f;
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        uint4 pf[KS];
#pragma unroll
        for (int h = 0; h < KS; ++h) pf[h] = wpf[(st * KS + h) * 32];
        float cr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < KS; ++h) mma(cr, qs[h], pf[h].x, pf[h].y);
#pragma unroll
        for (int h = 0; h < KS; ++h) mma(cr, qb[h], pf[h].z, pf[h].w);
#pragma unroll
        for (int h = 0; h < KS; ++h) mma(cr, qb[h], pf[h].x, pf[h].y);
        const float2 cm = MASKED ? wcm[st * 32] : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bit = 16 * (st & 1) + 2 * (i & 1);
          const uint32_t u = i < 2 ? ua[st >> 1] : ub[st >> 1];
          const float rec = fminf(fmaxf(cr[i], 0.f), 1.f);
          float w, t;
          bce_term(rec, (u & (1u << bit)) != 0u, (u & (2u << bit)) != 0u,
                   w, t);
          if (MASKED)
            acc += __fmul_rn(__fmul_rn(w, t),
                             (i & 1 ? cm.y : cm.x) * (i < 2 ? rwa : rwb));
          else
            acc = fmaf(w, t, acc);
        }
      }
      lane_loss += acc;
      j = jn;
      if (cn != c) {
        c = cn;
        if (it + 1 < n_mine) load_p(c);
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

// The term alone, elementwise on n (rec, code) pairs: out = bce_elem_code.
__global__ void term_check_kernel(const float* __restrict__ rec,
                                  const int32_t* __restrict__ code,
                                  float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = bce_elem_code(rec[i], (uint32_t)code[i]);
}

// *loss = the per-block partials summed in block order, by one thread.
__global__ void bce_sum_reduce_kernel(const float* __restrict__ loss_part,
                                      int n_blocks, float* __restrict__ loss) {
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += loss_part[b];
  *loss = s;
}

template <int KS, bool MASKED, bool NO_MISSING>
cudaError_t launch(const uint32_t* packed, const float* q, const float* P,
                   const float* col_mask, const float* row_w,
                   const int32_t* blk_idx, int blk, float* loss,
                   float* loss_part, int64_t B, int64_t W4, int k,
                   int n_blocks, cudaStream_t stream) {
  auto kernel = bce_sum_kernel<KS, MASKED, NO_MISSING>;
  const int64_t b16 = (B + 15) / 16 * 16;
  const int cap = (int)(b16 < Geom<KS>::kRows ? b16 : Geom<KS>::kRows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<KS>(Geom<KS>::kRows));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem_bytes<KS>(cap), stream>>>(
      packed, q, P, col_mask, row_w, blk_idx, blk, loss_part, B, W4, k, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bce_sum_reduce_kernel<<<1, 1, 0, stream>>>(loss_part, n_blocks, loss);
  return cudaGetLastError();
}

template <int KS>
cudaError_t dispatch(const uint32_t* packed, const float* q, const float* P,
                     const float* col_mask, const float* row_w,
                     const int32_t* blk_idx, int blk, float* loss,
                     float* loss_part, int64_t B, int64_t W4, int k,
                     int n_blocks, int masked, int no_missing,
                     cudaStream_t s) {
#define NA_BCE_SUM_LAUNCH(M, N)                                              \
  launch<KS, M, N>(packed, q, P, col_mask, row_w, blk_idx, blk, loss,       \
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

// SNP chunks of the plane for k (a bound on the blocks that get work).
long long na_bce_sum_tiles(long long W, int k) {
  const int chunk = k <= 8 ? Geom<1>::kChunk : Geom<2>::kChunk;
  return (W * 4 + chunk - 1) / chunk;
}

// The kernel's term (bce_elem_code) on n fp32 rec in [0, 1] and int32 codes
// 0-3, into out, on the device. Returns the cudaError_t of the launch.
int na_bce_sum_term_check(const void* rec, const void* code, void* out,
                          long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  term_check_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), static_cast<const int32_t*>(code),
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// packed: (rows, W) uint8, W % 4 == 0, 4-byte aligned: the batch itself
// (blk_idx null, rows = B) or the resident rows that the (B / blk,) int32
// blk_idx indexes (K7); q (B, k); P (k, 4W); col_mask (4W) and row_w (B),
// read only when masked; loss (1) written; loss_part (n_blocks) scratch. All
// fp32 and contiguous; 1 <= k <= 16, B >= 1; no_missing: no code is 3 (the
// kernel then skips zeroing them). Returns the cudaError_t of the launches
// (0 = cudaSuccess).
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
  if (k <= 8)
    return dispatch<1>(pk, qf, Pf, cm, rw, bi, blk, lf, lpart, B, W4, k,
                       n_blocks, masked, no_missing, s);
  return dispatch<2>(pk, qf, Pf, cm, rw, bi, blk, lf, lpart, B, W4, k,
                     n_blocks, masked, no_missing, s);
}

}  // extern "C"
