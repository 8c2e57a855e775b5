"""A CPU model of the xv kernel's int8 tensor-core layout (csrc/xv.cu, K2),
held against the plain version ``xv_plain`` and against exact integer
arithmetic.

The model walks the batch as the kernel does: launches of at most
``MAX_SUMS / Dp`` rows, blocks over contiguous ranges of 512-SNP chunks,
warp w over the 16-row tiles w, w + 8, ..., lane = 4g + t. It writes the
m16n8k32 .s8 fragment maps of A, B and C and the SNP permutation of the
32-wide k index as integer index arrays, and builds each mma's operands
from per-lane registers through them: A from the packed u32 words that a
lane loads (its row g and g + 8, words 8t .. 8t + 7 of the chunk), decoded
at the kernel's shifts, (u >> 2j) & 0x03030303; B from the staging threads'
registers, V cut per chunk and column into a power-of-two scale 2^e and
three int8 pieces (hi, mid, lo). It accumulates each piece's products in
int32 over the chunk's 16 k-steps, folds the three accumulators in int64,
rounds once to fp32, scales by 2^e, adds into the row's fp32 running sum
in chunk order, halves, and sums the blocks' partials in block order. It
asserts that:

* the model is within PERF.md section 2's rule of ``xv_plain``, |d| <=
  1e-5 * sum|x||V| + 1e-6, at ragged B, m_pad not a multiple of 512, D in
  {1, 5, 8, 16, 32}, with and without code 3, and on a V whose one column
  holds, in every 512-SNP chunk, a single entry 1000 times the rest;
* the pieces rebuild v exactly and stay in [-128, 127] at the edges of the
  scale's range, at carries into hi and on a zero column;
* the int32 accumulators stay far from overflow at the largest chunk;
* the model's Xp equals, bit for bit, exact int64 products of the codes
  and the scaled V followed by the kernel's rounding sequence: so the
  fragment maps and the SNP permutation pair each code with its own V.

What the model cannot show: the card's instructions (that the mma reads
its registers as the PTX ISA's table says), shared memory (bank order,
barriers), registers and timing. Only phase 3 of chip_smoke.py on the
card shows those.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.ops.xv import xv_plain

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
BYTE = np.arange(4)
# Fragment maps of mma.m16n8k32.row.col.s32.s8.s8.s32, register r of each
# lane -> (row, first k); byte i of the register is k + i. A 16x32, B 32x8
# (k, n), C 16x8 (one int32 a register: (row, column)).
A_ROW = np.stack([G, G + 8, G, G + 8], 1)
A_K = np.stack([4 * T, 4 * T, 16 + 4 * T, 16 + 4 * T], 1)
B_K = np.stack([4 * T, 16 + 4 * T], 1)
B_N = np.stack([G, G], 1)
C_ROW = np.stack([G, G, G + 8, G + 8], 1)
C_COL = np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1)
STEPS, CHUNK, WARPS, THREADS = 16, 512, 8, 256
MAX_SUMS, MIN_EXP = 8192, -100
MASK = 0x03030303


def snp_of(s, k):
    """The SNP (offset in its 512-SNP chunk) at k position k of k-step s:
    k = 16 hb + 4 t + i is byte i of lane t's word 8t + 2(s >> 2) + hb,
    whose slice j = s & 3 holds SNPs 4i + j of that word."""
    t, i, hb = (k % 16) // 4, k % 4, k // 16
    return 16 * (8 * t + 2 * (s >> 2) + hb) + 4 * i + (s & 3)


SNP_OF = snp_of(np.arange(STEPS)[:, None], np.arange(32)[None])  # (16, 32)


def n_tiles_of(D):
    """The kernel's n-tiles of 8 columns: D <= 8 one, else 2 or 4."""
    return 1 if D <= 8 else (2 if D <= 16 else 4)


def unpack_word(u):
    m = u & (u >> 1) & 0x55555555
    return u & ~(m | (m << 1)) & 0xFFFFFFFF


def scale_exp(amax):
    """e, the smallest integer with amax 2^-e <= 127 2^16 (amax = m 2^E,
    m in [0.5, 1): E - 23 or E - 22), at least MIN_EXP; 0 for a zero
    column."""
    amax = np.asarray(amax, np.float32)
    m, E = np.frexp(amax)
    e = np.where(m * np.float32(2 ** 23) <= np.float32(127 * 2 ** 16),
                 E - 23, E - 22)
    return np.where(amax > 0, np.maximum(e, MIN_EXP), 0).astype(np.int64)


def pow2(e):
    return np.ldexp(np.float32(1.0), e).astype(np.float32)


def quantize(vals, e):
    """rint(V 2^-e) as the kernel computes it: one fp32 multiply by the
    exact power of two, rounded half to even."""
    return np.rint(np.asarray(vals, np.float32) * pow2(-e)).astype(np.int64)


def cut(q):
    """Balanced int8 pieces of q: lo, mid, hi with q = lo + 256 mid +
    65536 hi, each in [-128, 127] for |q| <= 127 2^16."""
    lo = ((q + 128) & 255) - 128
    r1 = (q - lo) >> 8
    mid = ((r1 + 128) & 255) - 128
    return lo, mid, (r1 - mid) >> 8


def s8(x):
    """Byte of an int, as the signed int8 the mma reads."""
    x = x & 0xFF
    return np.where(x >= 128, x - 256, x)


def stage(V, c, D, NT):
    """One chunk's staging by the block's 256 threads. Thread (lane =
    4g + t, warp = 2j + hb) takes, for k = 0..3 and each n-tile, the SNPs
    16(8t + 2k + hb) + 4i + j (i = 0..3) of column 8 nt + g: one register of
    each piece, written where lane 4g + t reads register hb of k-step
    4k + j. Returns (e (Dp,), 2^e (Dp,) fp32, regs (16, NT, 3, 32, 2)
    uint32)."""
    m_pad = V.shape[0]
    Dp = 8 * NT
    tid = np.arange(THREADS)
    lane, warp = tid & 31, tid >> 5
    hb, j = warp & 1, warp >> 1
    g, t = lane >> 2, lane & 3
    k = np.arange(4)[None, :, None, None]
    nt = np.arange(NT)[None, None, :, None]
    i = BYTE[None, None, None, :]
    word = (8 * t + hb)[:, None, None, None] + 2 * k
    snp = c * CHUNK + 16 * word + 4 * i + j[:, None, None, None]
    col = 8 * nt + g[:, None, None, None]
    snp, col = np.broadcast_arrays(snp, col)  # (256, 4, NT, 4)
    ok = (snp < m_pad) & (col < D)
    vals = np.where(ok, V[np.minimum(snp, m_pad - 1),
                          np.minimum(col, D - 1)], 0).astype(np.float32)
    amax = np.zeros(Dp, np.float32)  # over the chunk (any order: a max)
    np.maximum.at(amax, col.ravel(), np.abs(vals).ravel())
    e = scale_exp(amax)
    q = quantize(vals, e[col])
    regs = np.zeros((STEPS, NT, 3, 32, 2), np.uint32)
    for p, piece in enumerate(cut(q)):
        assert piece.min() >= -128 and piece.max() <= 127
        reg = ((piece & 0xFF) << (8 * i)).sum(-1)  # (256, 4, NT)
        s = 4 * k[..., 0] + j[:, None, None]
        regs[s, np.arange(NT)[None, None, :], p, lane[:, None, None],
             hb[:, None, None]] = reg
    return e, pow2(e), regs


def b_matrix(regs):
    """(16, NT, 3, 32, 8) int64: the B operand of each k-step, n-tile and
    piece, from the lanes' registers through the B fragment map."""
    Bm = np.zeros(regs.shape[:3] + (32, 8), np.int64)
    for hb in range(2):
        for i in BYTE:
            Bm[:, :, :, B_K[:, hb] + i, B_N[:, hb]] = s8(
                regs[..., hb].astype(np.int64) >> (8 * i))
    return Bm


def a_matrix(u):
    """(n_tiles, 16, 16, 32) int64: the A operand of each tile and k-step.
    ``u`` (n_tiles, 32, 2, 8): lane l's words 8t .. 8t + 7 of rows g and
    g + 8. Register r of step s is the slice j = s & 3 of word 2(s >> 2) +
    (r >= 2) of row half r % 2."""
    s = np.arange(STEPS)
    r = np.arange(4)
    word = 2 * (s[:, None] >> 2) + (r[None] >= 2)  # (16, 4)
    half = np.broadcast_to(r % 2, word.shape)
    regs = (u[:, :, half, word] >> (2 * (s[:, None] & 3))) & MASK
    regs = regs.transpose(0, 2, 1, 3)  # (n_tiles, 16, 32, 4)
    A = np.zeros((u.shape[0], STEPS, 16, 32), np.int64)
    for i in BYTE:
        A[:, :, A_ROW, A_K + i] = s8(regs >> (8 * i))
    return A


def model_xv(packed, V, n_split, no_missing=False, stats=None):
    """Xp (B, D) fp32 by the kernel's walk; ``stats`` collects the largest
    |int32 accumulator| and the tiles and chunks each block covered."""
    B, W = packed.shape
    W4, D = W // 4, V.shape[1]
    NT = n_tiles_of(D)
    Dp = 8 * NT
    words = np.ascontiguousarray(packed).view("<u4").astype(np.int64)
    n_chunks = -(-W4 // 32)
    stats = {} if stats is None else stats
    stats.update(acc_max=0, launches=0, covered=[])
    partial = np.zeros((n_split, B, D), np.float32)
    for r0 in range(0, B, MAX_SUMS // Dp):
        rows = min(MAX_SUMS // Dp, B - r0)
        n_tiles = -(-rows // 16)
        stats["launches"] += 1
        # warp w takes the tiles w, w + 8, ...: each once
        order = [tl for w in range(WARPS) for tl in range(w, n_tiles, WARPS)]
        assert sorted(order) == list(range(n_tiles))
        tile = np.arange(n_tiles)
        row = 16 * tile[:, None, None] + G[None, :, None] + 8 * np.arange(2)
        for split in range(n_split):
            c0 = n_chunks * split // n_split
            c1 = n_chunks * (split + 1) // n_split
            sums = np.zeros((16 * n_tiles, Dp), np.float32)
            for c in range(c0, c1):
                stats["covered"].append((r0, c))
                e, scale, regs = stage(V, c, D, NT)
                Bm = b_matrix(regs)
                wi = c * 32 + 8 * T[:, None] + np.arange(8)  # (32, 8)
                ok = (row < rows)[..., None] & (wi < W4)[None, :, None, :]
                u = np.where(ok, words[np.minimum(r0 + row, B - 1)[..., None],
                                       np.minimum(wi, W4 - 1)[None, :, None]],
                             0)
                if not no_missing:
                    u = unpack_word(u)
                A = a_matrix(u)
                prods = np.einsum("xsmk,snpkc->xsnpmc", A, Bm)
                acc = prods.cumsum(1)  # the accumulator after each k-step
                stats["acc_max"] = max(stats["acc_max"],
                                       int(np.abs(acc).max()))
                frag = acc[:, -1][..., C_ROW, C_COL]  # (x, NT, 3, 32, 4)
                lo, mid, hi = frag[:, :, 0], frag[:, :, 1], frag[:, :, 2]
                tt = hi * 65536 + (mid * 256 + lo)  # int64, exact
                col = 8 * np.arange(NT)[:, None, None] + C_COL
                f = tt.astype(np.float32) * scale[col]
                rr = 16 * tile[:, None, None, None] + C_ROW
                sums[rr, np.broadcast_to(col, f.shape)] += f
            partial[split, r0:r0 + rows] = np.float32(0.5) * sums[:rows, :D]
    out = np.zeros((B, D), np.float32)
    for k in range(n_split):
        out += partial[k]
    return out


def exact_xv(packed, V, n_split):
    """The kernel's rounding sequence on exact integers: per block, chunk
    and column, T = sum_m g(b, m) q(m) in int64 (q = rint(V 2^-e)); fp32(T)
    2^e added in chunk order; halved; blocks summed in order."""
    B, W = packed.shape
    m_pad, D = 4 * W, V.shape[1]
    codes = (packed[:, :, None] >> (2 * np.arange(4))) & 3
    codes = np.where(codes == 3, 0, codes).reshape(B, m_pad).astype(np.int64)
    n_chunks = -(-m_pad // CHUNK)
    out = np.zeros((B, D), np.float32)
    for split in range(n_split):
        sums = np.zeros((B, D), np.float32)
        for c in range(n_chunks * split // n_split,
                       n_chunks * (split + 1) // n_split):
            v = V[c * CHUNK:(c + 1) * CHUNK]
            e = scale_exp(np.abs(v).max(0))
            Tm = codes[:, c * CHUNK:(c + 1) * CHUNK] @ quantize(v, e)
            sums += Tm.astype(np.float32) * pow2(e)
        out += np.float32(0.5) * sums
    return out


def _case(seed, B, m_pad, D, missing, M=None, spike=False):
    """Packed rows (codes 0..3, or 0..2) and V (m_pad, D) fp32, columns
    from M on padding (codes 0, V 0). ``spike``: column 0 holds in every
    512-SNP chunk one entry 1000 times the largest of the rest."""
    rng = np.random.default_rng(seed)
    M = m_pad if M is None else M
    Gm = rng.integers(0, 4 if missing else 3, size=(B, m_pad)).astype(
        np.uint8)
    Gm[:, M:] = 0
    V = (rng.normal(size=(m_pad, D)) * 0.05).astype(np.float32)
    if spike:
        V[:, 0] = rng.uniform(-1, 1, size=m_pad) * 0.05
        for c0 in range(0, M, CHUNK):
            V[c0 + rng.integers(0, min(CHUNK, M - c0)), 0] = 50.0 * (
                1 if rng.uniform() < 0.5 else -1)
    V[M:] = 0
    return pack_2bit_rows(Gm, m_pad=m_pad), V


def _assert_within_rule(got, packed, V):
    p, v = torch.from_numpy(packed), torch.from_numpy(V)
    want = xv_plain(p, v).numpy()
    bound = 1e-5 * xv_plain(p, v.abs()).numpy() + 1e-6
    err = np.abs(got - want)
    assert (err <= bound).all(), (
        f"max|d| {err.max():.3e}, worst |d|/bound {(err / bound).max():.3f}")
    return (err / bound).max()


def test_fragment_maps_and_the_snp_permutation():
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
    # the 16 k-steps cover the chunk's 512 SNPs once
    assert sorted(SNP_OF.ravel()) == list(range(CHUNK))
    # A: lane (g, t)'s register r at step s holds, in byte i, k position
    # A_K + i of a row, which SNP_OF maps to SNP 4i + j of one of the
    # lane's own words 8t .. 8t + 7: the slice (u >> 2j) & 0x03030303 as
    # it stands
    for s in range(STEPS):
        for r in range(4):
            k = A_K[:, r][:, None] + BYTE
            word = 8 * T + 2 * (s >> 2) + (r >= 2)
            assert (SNP_OF[s, k] == 16 * word[:, None] + 4 * BYTE
                    + (s & 3)).all()
    # B: the staging thread (lane, hb, j, k) writes, in byte i, SNP
    # 16(8t + 2k + hb) + 4i + j: the SNP that B's k position B_K + i of
    # register hb of step 4k + j stands for
    for s in range(STEPS):
        for hb in range(2):
            k = B_K[:, hb][:, None] + BYTE
            word = 8 * T + 2 * (s >> 2) + hb
            assert (SNP_OF[s, k] == 16 * word[:, None] + 4 * BYTE
                    + (s & 3)).all()


def test_pieces_rebuild_v_and_stay_in_int8():
    top = 127 * 2 ** 16
    q = np.array([top, -top, top - 1, -(top - 1), 0, 1, -1, 127, 128, -128,
                  -129, 255, 256, 32767, 32768, -32768, -32769, 65535 + 128,
                  65536 * 5 - 129, -65536 * 7 + 127, 2 ** 22 + 128 * 257,
                  top - 128, -(top - 127)], np.int64)
    q = np.concatenate([q, np.random.default_rng(0).integers(
        -top, top + 1, size=20000)])
    lo, mid, hi = cut(q)
    for piece in (lo, mid, hi):
        assert piece.min() >= -128 and piece.max() <= 127
    assert (lo + 256 * mid + 65536 * hi == q).all()
    # values that carry into hi: lo and mid both round up
    assert cut(np.array([65536 - 1]))[2][0] == 1
    assert cut(np.array([2 ** 15 + 2 ** 7]))[2][0] == 1
    # the scale: amax 2^-e reaches 127 2^16 at most, and at least half
    # of it (e is the smallest that fits)
    rng = np.random.default_rng(1)
    amax = np.concatenate([
        np.float32(top) * np.float32([1.0, 1.0 + 2 ** -23, 1 - 2 ** -24]),
        (rng.uniform(0.5, 1, 4000) * 2.0 ** rng.integers(-70, 100, 4000)),
        np.ldexp(1.0, np.arange(-60, 100))]).astype(np.float32)
    e = scale_exp(amax)
    qmax = quantize(amax, e)
    assert qmax.max() <= top and (qmax >= top // 2).all()
    assert e[0] == 0 and e[1] == 1 and e[2] == 0
    # a zero column: e = 0, zero pieces; a tiny one: e = MIN_EXP
    assert scale_exp(np.float32(0.0)) == 0
    assert scale_exp(np.float32(1e-30)) == MIN_EXP
    V = np.zeros((2048, 3), np.float32)
    V[:, 1] = np.float32(top)
    V[::3, 2] = -np.float32(top) * 2 ** 40
    e, scale, regs = stage(V, 1, 3, 1)
    assert e[0] == 0 and e[1] == 0 and e[2] == 40 and (e[3:] == 0).all()
    Bm = b_matrix(regs)
    assert not Bm[..., 0].any() and not Bm[..., 3:].any()
    # column 1 is 127 2^16 everywhere: hi 127, mid 0, lo 0
    assert (Bm[:, 0, 2, :, 1] == 127).all() and not Bm[:, 0, :2, :, 1].any()
    rebuilt = Bm[:, 0, 0] + 256 * Bm[:, 0, 1] + 65536 * Bm[:, 0, 2]
    want = np.zeros((STEPS, 32, 8), np.int64)
    want[..., 1] = top
    want[..., 2] = np.where(SNP_OF % 3 == 1, -top, 0)  # chunk 1 starts at 512
    assert (rebuilt == want).all()


def test_int32_accumulators_at_the_largest_chunk():
    """Every code 2 against V at both extremes of the pieces: the largest
    accumulator stays at most 2 * 128 * 512 = 2^17, far below 2^31."""
    B, m_pad = 16, 1024
    packed = pack_2bit_rows(np.full((B, m_pad), 2, np.uint8))
    V = np.zeros((m_pad, 4), np.float32)
    V[:, 0] = -np.float32(127 * 2 ** 16 - 128)  # lo -128 on every SNP
    V[:, 1] = np.float32(127 * 2 ** 16)
    V[:, 2] = np.float32(-(127 * 2 ** 16))
    V[:, 3] = np.float32(2 ** 16 * 127 - 128 * 257)  # lo and mid -128
    stats = {}
    got = model_xv(packed, V, 2, no_missing=True, stats=stats)
    assert stats["acc_max"] <= 2 * 128 * CHUNK < 2 ** 31
    assert stats["acc_max"] >= 2 * 127 * CHUNK
    assert (got == exact_xv(packed, V, 2)).all()
    assert (got == np.float32(m_pad) * V[0]).all()  # x = 1 everywhere


@pytest.mark.parametrize("D", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("B,m_pad,n_split,missing", [
    (1, 1040, 1, True), (15, 2064, 3, False), (17, 1552, 2, True),
    (130, 1040, 2, True)])
def test_model_matches_plain_and_exact(B, m_pad, n_split, missing, D):
    packed, V = _case(B * 7 + D, B, m_pad, D, missing, M=m_pad - 12)
    stats = {}
    got = model_xv(packed, V, n_split, no_missing=not missing, stats=stats)
    n_chunks = -(-m_pad // CHUNK)
    assert sorted(stats["covered"]) == [(0, c) for c in range(n_chunks)]
    assert (got.view(np.int32) == exact_xv(packed, V, n_split)
            .view(np.int32)).all()
    _assert_within_rule(got, packed, V)


def test_model_in_two_launches_by_rows():
    """D = 32: 256 rows a launch, so 300 rows take two; rows are
    independent, so each launch's rows equal the exact sequence."""
    packed, V = _case(5, 300, 528, 32, True)
    stats = {}
    got = model_xv(packed, V, 2, stats=stats)
    assert stats["launches"] == 2
    assert (got == exact_xv(packed, V, 2)).all()
    _assert_within_rule(got, packed, V)


@pytest.mark.parametrize("missing", [True, False])
def test_spike_column_within_the_rule(missing):
    """One entry of every 512-SNP chunk 1000 times the rest in column 0:
    the rest keep 2^-23 of the spike's scale, far inside the rule."""
    packed, V = _case(11, 37, 2576, 8, missing, M=2570, spike=True)
    got = model_xv(packed, V, 3, no_missing=not missing)
    assert (got == exact_xv(packed, V, 3)).all()
    worst = _assert_within_rule(got, packed, V)
    assert worst < 0.5
