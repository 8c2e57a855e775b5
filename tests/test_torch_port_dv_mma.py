"""A CPU model of the dv kernel's int8 tensor-core layout (csrc/dv.cu, K5),
held against the plain version ``dv_plain`` and against exact integer
arithmetic.

dV (m_pad, D) = X^T dXp is a sum over batch rows. The kernel's mma is
m16n8k32 .s8: M = 16 SNPs, N = 8 columns of dXp, K = 32 batch rows. The
model walks the batch as the kernel does: launches of at most
``ROWS_PER_LAUNCH`` rows (a later launch adds into dV), groups of 8
columns (one launch each), 512-SNP tiles (warp w owns words 4w .. 4w + 3
of a tile: 4 m-tiles), k-steps of 32 rows staged by the block's 256
threads into a swizzled ring slot, chunks of ``CHUNK_ROWS`` rows. It writes
the m16n8k32 .s8 fragment maps of A, B and C and the M and K bijections as
integer index arrays, and builds each mma's operands from per-lane
registers: A from the u32 words that a lane reads from the staged rows (its
word of 4 rows at a time), byte-transposed by two stages of ``PRMT``
(``byte_perm``), masked, and sliced at the kernel's shifts,
(T >> 2j) & 0x03030303; B from the staging threads' registers, dXp cut per
chunk and column into a power-of-two scale 2^e and four int8 pieces. It
accumulates each piece's products in int32 over the chunk's k-steps, folds
the four accumulators in int64, rounds once to fp32, scales by 2^e, adds
into the output's fp32 running sum in chunk order, and halves. It asserts
that:

* the model is within PERF.md section 2's rule of ``dv_plain``, |d| <=
  1e-5 * sum_b |x||dXp| + 1e-6, at ragged B (1, 31, 33, 96, 300: over one
  chunk), m_pad not a multiple of 512, D in {1, 5, 8, 16, 32}, with and
  without code 3, and bit for bit equal to exact int64 products followed by
  the kernel's rounding sequence;
* every SNP of a tile lands exactly once under the M map, every row of a
  k-step exactly once under the K map, and the A and B operands pair each
  code with the dXp row it multiplies;
* the ring slot's swizzle: the copy threads fill each word once, and the
  lanes of one read instruction hit 32 distinct banks or share a word;
* the pieces rebuild v exactly and stay in [-128, 127] at the edges of the
  scale's range, at carries into the top piece and on a zero column;
* the int32 accumulators cannot overflow at CHUNK_ROWS;
* a column of dXp in which one row of every chunk is 1000 times the rest,
  on codes that are 0 in that row, stays within the rule with four pieces,
  and breaks it with three (why the kernel takes a fourth);
* two launches by rows give the model's definition of that path.

What the model cannot show: the card's instructions (that the mma and
``PRMT`` read their registers as the PTX ISA says), the banks the hardware
actually serialises, ``cp.async`` and its ordering against the barriers,
registers and timing. Only phase 3 of chip_smoke.py on the card shows those.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.ops.dv import dv_plain

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
BYTE = np.arange(4)
# Fragment maps of mma.m16n8k32.row.col.s32.s8.s8.s32, register r of each
# lane -> (row, first k); byte i of the register is k + i. A 16x32 (m, k),
# B 32x8 (k, n), C 16x8 (one int32 a register: (row, column)).
A_ROW = np.stack([G, G + 8, G, G + 8], 1)
A_K = np.stack([4 * T, 4 * T, 16 + 4 * T, 16 + 4 * T], 1)
B_K = np.stack([4 * T, 16 + 4 * T], 1)
B_N = np.stack([G, G], 1)
C_ROW = np.stack([G, G, G + 8, G + 8], 1)
C_COL = np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1)
WARPS, THREADS = 8, 256
TILE_WORDS, TILE_SNPS = 32, 512          # a warp owns 4 words: 4 m-tiles
STEP_ROWS, CHUNK_ROWS = 32, 256          # a k-step; a chunk of 8 k-steps
ROWS_PER_LAUNCH = 2048
PIECES, MIN_EXP = 4, -100
MASK = 0x03030303


def k_row(k):
    """The batch row (of its k-step) at K position k = 16h + 4t + r: row
    16h + t + 4r, so that the 4 lanes t of a group read 4 consecutive rows
    at once."""
    h, t, r = k // 16, (k % 16) // 4, k % 4
    return 16 * h + t + 4 * r


K_ROW = k_row(np.arange(32))


def m_snp(w, j, mrow):
    """The SNP (of its 512-SNP tile) at M row ``mrow`` of m-tile j of warp
    w: row g (and g + 8) is byte i0 = 2(g >> 2) (and i1 = i0 + 1) of word
    4w + (g & 3), slice j: SNP 4i + j of that word."""
    g, half = mrow % 8, mrow // 8
    return 16 * (4 * w + (g & 3)) + 4 * (2 * (g >> 2) + half) + j


M_SNP = m_snp(np.arange(WARPS)[:, None, None], np.arange(4)[None, :, None],
              np.arange(16)[None, None, :])  # (8, 4, 16)


def slot(row, word):
    """Word address in a ring slot (32 rows x 128 bytes) of word ``word``
    (0..31) of staged row ``row``: 16-byte chunks XOR-swizzled by row % 8."""
    return 32 * row + 4 * ((word >> 2) ^ (row & 7)) + (word & 3)


def unpack_word(u):
    m = u & (u >> 1) & 0x55555555
    return u & ~(m | (m << 1)) & 0xFFFFFFFF


def byte_perm(x, y, s):
    """PRMT (__byte_perm): byte n of the result is byte (s >> 4n) & 7 of
    the 8 bytes [x, y]."""
    out = np.zeros(np.broadcast(x, y, s).shape, np.int64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        b = np.where(sel < 4, x >> (8 * (sel & 3)), y >> (8 * (sel & 3)))
        out |= (b & 0xFF) << (8 * n)
    return out


def scale_exp(amax, pieces=PIECES):
    """e, the smallest integer with amax 2^-e <= 127 2^(8 (pieces - 1))
    (amax = m 2^E, m in [0.5, 1): E - s or E - s + 1, s = 8 pieces - 1),
    at least MIN_EXP; 0 for a zero column."""
    amax = np.asarray(amax, np.float32)
    m, E = np.frexp(amax)
    s = 8 * pieces - 1
    e = np.where(m <= np.float32(127 / 128), E - s, E - s + 1)
    return np.where(amax > 0, np.maximum(e, MIN_EXP), 0).astype(np.int64)


def pow2(e):
    return np.ldexp(np.float32(1.0), e).astype(np.float32)


def quantize(vals, e):
    """rint(dXp 2^-e) as the kernel computes it: one fp32 multiply by the
    exact power of two, rounded half to even."""
    return np.rint(np.asarray(vals, np.float32) * pow2(-e)).astype(np.int64)


def cut(q, pieces=PIECES):
    """Balanced int8 pieces of q, lowest first: q = sum_k p_k 256^k, each in
    [-128, 127] for |q| <= 127 2^(8 (pieces - 1))."""
    out = []
    for _ in range(pieces - 1):
        p = ((q + 128) & 255) - 128
        out.append(p)
        q = (q - p) >> 8
    return out + [q]


def s8(x):
    """Byte of an int, as the signed int8 the mma reads."""
    x = x & 0xFF
    return np.where(x >= 128, x - 256, x)


def stage_pieces(dxp, col0, pieces=PIECES):
    """The block's cut of one launch's dXp rows (rows, D), columns col0 ..
    col0 + 7: per chunk of CHUNK_ROWS rows and column, e and 2^e; and the
    registers (n_ks, pieces, 32 lanes, 2) uint32 that lane 4g + t reads as
    b0, b1 of k-step ks: byte r of b_h is the piece of row ks 32 + 16h +
    t + 4r, column col0 + g (zero past the rows and D)."""
    rows, D = dxp.shape
    n_ks = -(-rows // STEP_ROWS)
    n_ch = -(-rows // CHUNK_ROWS)
    cols = col0 + np.arange(8)
    vals = np.zeros((n_ch * CHUNK_ROWS, 8), np.float32)
    vals[:rows, cols < D] = dxp[:, cols[cols < D]]
    amax = np.abs(vals).reshape(n_ch, CHUNK_ROWS, 8).max(1)  # order-free
    e = scale_exp(amax, pieces)  # (n_ch, 8)
    ks = np.arange(n_ks)[:, None, None, None]
    h = np.arange(2)[None, None, :, None]
    row = ks * 32 + 16 * h + T[None, :, None, None] + 4 * BYTE  # (ks,32,2,4)
    g = np.broadcast_to(G[None, :, None, None], row.shape)
    q = quantize(vals[row, g], e[row // CHUNK_ROWS, g])
    regs = np.zeros((n_ks, pieces, 32, 2), np.uint32)
    for p, piece in enumerate(cut(q, pieces)):
        assert piece.min() >= -128 and piece.max() <= 127
        regs[:, p] = ((piece & 0xFF) << (8 * BYTE)).sum(-1)
    return e, pow2(e), regs


def b_matrix(regs):
    """(n_ks, pieces, 32, 8) int64: the B operand of each k-step and piece,
    from the lanes' registers through the B fragment map."""
    Bm = np.zeros(regs.shape[:2] + (32, 8), np.int64)
    for h in range(2):
        for i in BYTE:
            Bm[:, :, B_K[:, h] + i, B_N[:, h]] = s8(
                regs[..., h].astype(np.int64) >> (8 * i))
    return Bm


def stage_rows(words, rows_of_step, n_tiles):
    """One k-step's ring slot of every tile, (n_tiles, 1024) words, as the
    256 copy threads fill it: thread (row = tid >> 3, chunk c = tid & 7)
    copies words 4c .. 4c + 3 of the tile in its row to the swizzled
    chunk; zeros past the batch's rows or the row's words."""
    B, W4 = words.shape
    tid = np.arange(THREADS)
    row, c = tid >> 3, tid & 7
    src_w = (np.arange(n_tiles)[:, None, None] * TILE_WORDS
             + 4 * c[None, :, None] + BYTE)  # (tiles, 256, 4)
    b = rows_of_step[row][None, :, None]  # -1: past the batch
    ok = (b >= 0) & (src_w < W4)
    vals = np.where(ok, words[np.maximum(b, 0), np.minimum(src_w, W4 - 1)], 0)
    dst = 32 * row[:, None] + 4 * (c ^ (row & 7))[:, None] + BYTE
    buf = np.full((n_tiles, 1024), -1, np.int64)
    buf[:, dst] = vals
    return buf


def lane_words(buf):
    """(tiles, warps, 32 lanes, 2 h, 4 r): the words lane 4g + t of warp w
    reads, word 4w + (g & 3) of rows 16h + t + 4r (K positions 16h + 4t + r)
    of the slot."""
    w = np.arange(WARPS)[:, None, None, None]
    g, t = G[None, :, None, None], T[None, :, None, None]
    h, r = np.arange(2)[None, None, :, None], BYTE[None, None, None, :]
    return buf[:, slot(16 * h + t + 4 * r, 4 * w + (g & 3))]


def a_regs(u, no_missing):
    """(tiles, warps, 4 j, 32, 4): lane registers a0..a3 of m-tile j, from
    the words ``u`` (tiles, warps, 32, 2, 4): two PRMT stages give T_i =
    [u0.byte i, u1.byte i, u2.byte i, u3.byte i] for the lane's bytes i0 =
    2(g >> 2) and i1 = i0 + 1; the mask; then the slices."""
    i0 = 2 * (G >> 2)
    i1 = i0 + 1
    sel = (i0 | (4 + i0) << 4 | i1 << 8 | (4 + i1) << 12)[None, None, :, None]
    p01 = byte_perm(u[..., 0], u[..., 1], sel)  # (tiles, warps, 32, 2 h)
    p23 = byte_perm(u[..., 2], u[..., 3], sel)
    t_i = np.stack([byte_perm(p01, p23, 0x5410),
                    byte_perm(p01, p23, 0x7632)], -1)  # (..., 2 h, 2 i)
    if not no_missing:
        t_i = unpack_word(t_i)
    # a0: i0 of h 0, a1: i1 of h 0, a2: i0 of h 1, a3: i1 of h 1
    regs = t_i.reshape(t_i.shape[:3] + (4,))
    j = np.arange(4)[None, None, :, None, None]
    return (regs[:, :, None] >> (2 * j)) & MASK


def a_matrix(regs):
    """(..., 16, 32) int64: the A operand from the lane registers (..., 32,
    4) through the A fragment map."""
    A = np.zeros(regs.shape[:-2] + (16, 32), np.int64)
    for i in BYTE:
        A[..., A_ROW, A_K + i] = s8(regs >> (8 * i))
    return A


def fold(acc):
    """sum_k acc_k 256^k in int64 over the pieces axis (axis -3 of
    (..., pieces, 16, 8)), exact."""
    t = np.zeros(acc.shape[:-3] + acc.shape[-2:], np.int64)
    for p in range(acc.shape[-3] - 1, -1, -1):
        t = t * 256 + acc[..., p, :, :]
    return t


def model_dv(packed, dxp, no_missing=False, pieces=PIECES, stats=None):
    """dV (m_pad, D) fp32 by the kernel's walk; ``stats`` collects the
    largest |int32 accumulator|, the launches and the SNPs written."""
    B, W = packed.shape
    W4, D = W // 4, dxp.shape[1]
    m_pad = 16 * W4
    words = np.ascontiguousarray(packed).view("<u4").astype(np.int64)
    n_tiles = -(-W4 // TILE_WORDS)
    stats = {} if stats is None else stats
    stats.update(acc_max=0, launches=0)
    out = np.zeros((m_pad, D), np.float32)
    written = np.zeros((m_pad, D), np.int64)
    # the SNP of each lane's C register: (tiles, warps, 4 j, 32, 4)
    snp = (TILE_SNPS * np.arange(n_tiles)[:, None, None, None, None]
           + M_SNP[:, :, C_ROW])
    for r0 in range(0, B, ROWS_PER_LAUNCH):
        rows = min(ROWS_PER_LAUNCH, B - r0)
        n_ks = -(-rows // STEP_ROWS)
        stats["launches"] += 1
        for col0 in range(0, D, 8):
            _, scale, regs = stage_pieces(dxp[r0:r0 + rows], col0, pieces)
            Bm = b_matrix(regs)
            sums = np.zeros((n_tiles, WARPS, 4, 32, 4), np.float32)
            acc = 0
            for ks in range(n_ks):
                step_rows = ks * STEP_ROWS + np.arange(STEP_ROWS)
                rows_of_step = np.where(step_rows < rows, r0 + step_rows, -1)
                buf = stage_rows(words, rows_of_step, n_tiles)
                assert (buf >= 0).all()  # every word of the slot written
                A = a_matrix(a_regs(lane_words(buf), no_missing))
                acc = acc + np.einsum("twjmk,pkn->twjpmn", A, Bm[ks])
                stats["acc_max"] = max(stats["acc_max"],
                                       int(np.abs(acc).max()))
                if ks % 8 == 7 or ks == n_ks - 1:  # the chunk's fold
                    tt = fold(acc)[..., C_ROW, C_COL]  # (tiles, w, j, 32, 4)
                    f = tt.astype(np.float32) * scale[ks // 8][C_COL]
                    sums = sums + f
                    acc = 0
            col = col0 + np.broadcast_to(C_COL, snp.shape)
            ok = (snp < m_pad) & (col < D)
            half = np.float32(0.5) * sums
            s, c = snp[ok], col[ok]
            out[s, c] = half[ok] if r0 == 0 else out[s, c] + half[ok]
            np.add.at(written, (s, c), 1)
    stats["written"] = written
    return out


def exact_dv(packed, dxp, pieces=PIECES):
    """The kernel's rounding sequence on exact integers: per launch, chunk
    and column, T = sum_b g(b, m) q(b) in int64 (q = rint(dXp 2^-e));
    fp32(T) 2^e added in chunk order; halved; launches added in order."""
    B, W = packed.shape
    m_pad, D = 4 * W, dxp.shape[1]
    codes = (packed[:, :, None] >> (2 * np.arange(4))) & 3
    codes = np.where(codes == 3, 0, codes).reshape(B, m_pad).astype(np.int64)
    out = np.zeros((m_pad, D), np.float32)
    for r0 in range(0, B, ROWS_PER_LAUNCH):
        sums = np.zeros((m_pad, D), np.float32)
        for c0 in range(r0, min(B, r0 + ROWS_PER_LAUNCH), CHUNK_ROWS):
            c1 = min(c0 + CHUNK_ROWS, r0 + ROWS_PER_LAUNCH, B)
            v = dxp[c0:c1]
            e = scale_exp(np.abs(v).max(0), pieces)
            Tm = codes[c0:c1].T @ quantize(v, e)
            sums += Tm.astype(np.float32) * pow2(e)
        out = np.float32(0.5) * sums if r0 == 0 else (
            out + np.float32(0.5) * sums)
    return out


def _case(seed, B, m_pad, D, missing, M=None):
    """Packed rows (codes 0..3, or 0..2) with SNPs from M on padding (code
    0), and dXp (B, D) fp32."""
    rng = np.random.default_rng(seed)
    M = m_pad if M is None else M
    Gm = rng.integers(0, 4 if missing else 3, size=(B, m_pad)).astype(
        np.uint8)
    Gm[:, M:] = 0
    dxp = rng.normal(size=(B, D)).astype(np.float32)
    return pack_2bit_rows(Gm, m_pad=m_pad), dxp


def _spike_case(seed, B, m_pad, D, missing):
    """Column 0 of dXp: in every chunk of CHUNK_ROWS rows one row 1000
    times the largest of the rest, and that row's codes 0 at nearly every
    SNP, so that the outputs' sums hold only the small rows, which the
    chunk's scale (set by the spike) cuts coarsest."""
    rng = np.random.default_rng(seed)
    Gm = rng.integers(0, 4 if missing else 3, size=(B, m_pad)).astype(
        np.uint8)
    dxp = rng.normal(size=(B, D)).astype(np.float32)
    dxp[:, 0] = rng.uniform(-1, 1, size=B).astype(np.float32)
    for c0 in range(0, B, CHUNK_ROWS):
        r = c0 + rng.integers(0, min(CHUNK_ROWS, B - c0))
        dxp[r, 0] = 1000.0 * (1 if rng.uniform() < 0.5 else -1)
        Gm[r] = np.where(rng.uniform(size=m_pad) < 0.05, 2, 0)
    return pack_2bit_rows(Gm, m_pad=m_pad), dxp


def _ratio_to_rule(got, packed, dxp):
    """max |d| / (1e-5 sum_b |x||dXp| + 1e-6) against dv_plain."""
    p, d = torch.from_numpy(packed), torch.from_numpy(dxp)
    want = dv_plain(p, d).numpy()
    bound = 1e-5 * dv_plain(p, d.abs()).numpy() + 1e-6
    return (np.abs(got - want) / bound).max()


def test_fragment_maps_and_the_m_and_k_bijections():
    for rows, first, shape in ((A_ROW, A_K, (16, 32)), (B_K, B_N, None)):
        hit = np.zeros((16, 32) if shape else (32, 8), np.int64)
        for i in BYTE:
            if shape:
                np.add.at(hit, (rows, first + i), 1)
            else:
                np.add.at(hit, (rows + i, first), 1)
        assert (hit == 1).all()
    hit = np.zeros((16, 8), np.int64)
    np.add.at(hit, (C_ROW, C_COL), 1)
    assert (hit == 1).all()
    # M: the 8 warps x 4 m-tiles x 16 rows cover the tile's 512 SNPs once;
    # K: the 32 positions cover the k-step's 32 rows once
    assert sorted(M_SNP.ravel()) == list(range(TILE_SNPS))
    assert sorted(K_ROW) == list(range(STEP_ROWS))
    # the 4 lanes t of a group read 4 consecutive rows in each instruction
    for h in range(2):
        for r in range(4):
            assert list(K_ROW[16 * h + 4 * T[:4] + r]) == list(
                16 * h + 4 * r + T[:4])


def test_operands_pair_each_code_with_its_row():
    """A built through the slot, PRMT and slices holds, at (M row, K
    position), the code of SNP M_SNP of the row K_ROW; B holds, at (K
    position, n), the piece of that row's dXp; so the mma sums code x piece
    over the k-step's rows."""
    rng = np.random.default_rng(3)
    B, W4 = 32, 64
    Gm = rng.integers(0, 4, size=(B, 16 * W4)).astype(np.uint8)
    words = pack_2bit_rows(Gm).view("<u4").astype(np.int64)
    buf = stage_rows(words, np.arange(B), 2)
    A = a_matrix(a_regs(lane_words(buf), no_missing=True))  # raw codes
    snp = TILE_SNPS * np.arange(2)[:, None, None, None] + M_SNP[None]
    want = Gm[K_ROW[None, None, None, None, :], snp[..., None]]
    assert (A == want).all()
    A = a_matrix(a_regs(lane_words(buf), no_missing=False))
    assert (A == np.where(want == 3, 0, want)).all()
    dxp = rng.integers(-100, 100, size=(B, 8)).astype(np.float32)
    dxp[0, 0] = 127 * 2 ** 24  # e = 0 in column 0: pieces are dXp itself
    e, _, regs = stage_pieces(dxp, 0)
    Bm = b_matrix(regs)[0]
    assert e[0, 0] == 0
    rebuilt = sum(Bm[p].astype(np.int64) << (8 * p) for p in range(PIECES))
    assert (rebuilt[:, 0] == dxp[K_ROW, 0]).all()


def test_ring_slot_swizzle_fills_once_and_reads_without_conflicts():
    tid = np.arange(THREADS)
    row, c = tid >> 3, tid & 7
    dst = (32 * row[:, None] + 4 * (c ^ (row & 7))[:, None] + BYTE).ravel()
    assert sorted(dst) == list(range(1024))
    # word w of row r lands where slot() reads it
    src = 32 * row[:, None] + 4 * c[:, None] + BYTE
    assert (slot(src.ravel() // 32, src.ravel() % 32) == dst).all()
    # one read instruction: fixed (warp, h, r), the 32 lanes
    for w in range(WARPS):
        for h in range(2):
            for r in range(4):
                addr = slot(16 * h + T + 4 * r, 4 * w + (G & 3))
                banks = {}
                for a in addr:
                    banks.setdefault(a % 32, set()).add(a)
                assert all(len(s) == 1 for s in banks.values())


def test_pieces_rebuild_v_and_stay_in_int8():
    top = 127 * 2 ** 24
    q = np.array([top, -top, top - 1, -(top - 1), 0, 1, -1, 127, 128, -128,
                  -129, 255, 256, 32767, 32768, -32768, -32769, 2 ** 24 - 1,
                  2 ** 24 - 129, 2 ** 23 + 2 ** 15 + 2 ** 7, -(2 ** 31) + 2 **
                  24 + 2 ** 25, top - 128, -(top - 127), 2 ** 30 + 2 ** 29],
                 np.int64)
    q = np.concatenate([q, np.random.default_rng(0).integers(
        -top, top + 1, size=20000)])
    parts = cut(q)
    for piece in parts:
        assert piece.min() >= -128 and piece.max() <= 127
    assert (sum(p << (8 * k) for k, p in enumerate(parts)) == q).all()
    # carries into the top piece: all lower pieces round up
    assert cut(np.array([2 ** 24 - 1]))[3][0] == 1
    assert cut(np.array([2 ** 23 + 2 ** 15 + 2 ** 7]))[3][0] == 1
    # the scale: amax 2^-e reaches 127 2^24 at most, and at least half of
    # it (e is the smallest that fits); q of the largest value never
    # passes int32
    rng = np.random.default_rng(1)
    amax = np.concatenate([
        np.float32(top) * np.float32([1.0, 1.0 + 2 ** -23, 1 - 2 ** -24]),
        (rng.uniform(0.5, 1, 4000) * 2.0 ** rng.integers(-60, 100, 4000)),
        np.ldexp(1.0, np.arange(-60, 100))]).astype(np.float32)
    e = scale_exp(amax)
    qmax = quantize(amax, e)
    assert qmax.max() <= top < 2 ** 31 and (qmax >= top // 2).all()
    assert e[0] == 0 and e[1] == 1 and e[2] == 0
    # a zero column: e = 0, zero pieces; a tiny one: e = MIN_EXP
    assert scale_exp(np.float32(0.0)) == 0
    assert scale_exp(np.float32(1e-30)) == MIN_EXP
    assert scale_exp(np.float32(2.0 ** -71)) == MIN_EXP  # -101 unclamped
    dxp = np.zeros((300, 3), np.float32)
    dxp[:, 1] = np.float32(top)
    dxp[::3, 2] = -np.float32(top) * 2 ** 40
    e, scale, regs = stage_pieces(dxp, 0)
    assert (e[:, 0] == 0).all() and (e[:, 1] == 0).all()
    assert (e[:, 2] == 40).all() and (e[:, 3:] == 0).all()
    Bm = b_matrix(regs)
    assert not Bm[..., 0].any() and not Bm[..., 3:].any()
    # column 1 is 127 2^24 on every row: top piece 127, the rest 0; rows
    # past 300 (k-step 9 holds 288..319) are zero pieces
    row = 32 * np.arange(Bm.shape[0])[:, None] + K_ROW
    live = row < 300
    assert (Bm[:, 3, :, 1][live] == 127).all()
    assert not Bm[:, :3, :, 1].any() and not Bm[:, 3, :, 1][~live].any()
    rebuilt = sum(Bm[:, p].astype(np.int64) << (8 * p) for p in range(PIECES))
    want = np.where(live & (row % 3 == 0), -top, 0)
    assert (rebuilt[..., 2] == want).all()


def test_int32_accumulators_at_a_full_chunk():
    """Every code 2 against dXp at both extremes of the pieces: the largest
    accumulator stays at most 2 * 128 * CHUNK_ROWS = 2^16, far below 2^31."""
    B, m_pad = 2 * CHUNK_ROWS, 512
    packed = pack_2bit_rows(np.full((B, m_pad), 2, np.uint8))
    top = 127 * 2 ** 24
    dxp = np.zeros((B, 4), np.float32)
    dxp[:, 0] = -np.float32(top - 128)        # lo -128 on every row
    dxp[:, 1] = np.float32(top)
    dxp[:, 2] = -np.float32(top)
    dxp[:, 3] = np.float32(top - 128 * 257)   # the two low pieces -128
    stats = {}
    got = model_dv(packed, dxp, no_missing=True, stats=stats)
    assert stats["acc_max"] <= 2 * 128 * CHUNK_ROWS < 2 ** 31
    assert stats["acc_max"] >= 2 * 127 * CHUNK_ROWS
    assert (got == exact_dv(packed, dxp)).all()
    assert (got == np.float32(B) * dxp[0]).all()  # x = 1 everywhere


@pytest.mark.parametrize("D", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("B,m_pad,missing", [
    (1, 1040, True), (31, 2064, False), (33, 1552, True), (96, 1040, False),
    (300, 1552, True)])
def test_model_matches_plain_and_exact(B, m_pad, missing, D):
    packed, dxp = _case(B * 7 + D, B, m_pad, D, missing, M=m_pad - 12)
    stats = {}
    got = model_dv(packed, dxp, no_missing=not missing, stats=stats)
    assert stats["launches"] == 1
    assert (stats["written"] == 1).all()  # every element once
    assert stats["acc_max"] <= 2 * 128 * CHUNK_ROWS
    assert (got.view(np.int32) == exact_dv(packed, dxp).view(np.int32)).all()
    assert _ratio_to_rule(got, packed, dxp) <= 1.0


def test_model_in_two_launches_by_rows():
    """More rows than one launch stages: the second launch adds its halved
    sums into dV, in order; the result is exact_dv's definition of that
    path, and within the rule."""
    B = ROWS_PER_LAUNCH + 52
    packed, dxp = _case(5, B, 528, 8, True)
    stats = {}
    got = model_dv(packed, dxp, stats=stats)
    assert stats["launches"] == 2 and (stats["written"] == 2).all()
    assert (got == exact_dv(packed, dxp)).all()
    assert _ratio_to_rule(got, packed, dxp) <= 1.0


@pytest.mark.parametrize("missing", [True, False])
def test_spike_column_needs_the_fourth_piece(missing):
    """One row of every chunk 1000 times the rest in column 0, its codes
    mostly 0: with four pieces the rest keep 2^-31 of the spike's scale,
    far inside the rule; three pieces (2^-23) break it."""
    packed, dxp = _spike_case(11, CHUNK_ROWS, 4112, 8, missing)
    got = model_dv(packed, dxp, no_missing=not missing)
    assert (got == exact_dv(packed, dxp)).all()
    assert _ratio_to_rule(got, packed, dxp) < 0.25
    assert _ratio_to_rule(exact_dv(packed, dxp, pieces=3), packed, dxp) > 1.0
