"""A CPU model of the dq_dp kernel's tensor-core layout (csrc/dq_dp.cu, K3
and K4), held against the plain version ``dq_dp_plain``.

The model walks the plane as the kernel does: blocks over whole 128-SNP
tiles, chunks of NS 8-SNP steps, warp w over the 16-row groups w, w + 8,
..., lane = 4g + t. It writes the m16n8k8 fragment maps of A, B and C and
the SNP (and head) permutation of the 8-wide k index as integer index
arrays, builds each mma's operands from per-lane registers through them,
splits every operand in 3xTF32 as the kernel does (q and P rounded to
TF32 as cvt.rna.tf32.f32 rounds, draw truncated to TF32, both emulated by
integer operations on the float's bits), decodes the 2-bit codes from the packed u32
words at the kernel's shifts, and keeps dP in per-lane accumulators on the
"CUDA cores". It asserts that:

* dq, dP and the loss agree with ``dq_dp_plain`` within PERF.md section 2's
  rule, |d| <= 1e-5 * (the same sum over absolute values) + 1e-6, on random
  planes and on the adversarial planes of tests/test_torch_port_bce_sum.py
  ``bce_plane``, the loss taken with K6's one-log term (csrc/bce.cuh
  ``bce_elem_code``, modelled by tests/bce_term_model.py), which also holds
  each term within 1e-6 of the float64 BCE of the model's own raw;
* on the 2^-10 grid of chip_smoke.py's phase 3 the split is exact
  (small = 0) and raw equals q @ P computed exactly, the clamp's boundary
  columns (raw = 0 and raw = 1) included;
* the accumulator fragment of raw, read as (c0, c2, c1, c3), is exactly the
  A fragment of draw under the SNP permutation;
* padded rows (past B in the last 16-row group), padded heads (past k) and
  padded SNP columns contribute exactly 0, and the chunks cover [0, m_pad)
  once.

What the model cannot show: the tensor core's own accumulation, the order
and rounding in which one mma adds its eight products to the accumulator
(the model sums them exactly and rounds once), nor anything of registers,
shared memory or timing. Only phase 3 of chip_smoke.py on the card shows
those.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.ops.dq_dp import dq_dp_plain
from neural_admixture_tpu_torch.ops.fused import (GRAD_EPS, draw_tile,
                                                  unpack_dosage)
from tests.bce_term_model import bce64, term_model
from tests.test_torch_port_bce_sum import bce_plane

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4
# Fragment maps of mma.m16n8k8 (.tf32, row.col), register r of each lane ->
# (row, column): A 16x8, B 8x8 (k, n), C 16x8.
A_ROW = torch.stack([G, G + 8, G, G + 8], 1)
A_COL = torch.stack([T, T, T + 4, T + 4], 1)
B_K = torch.stack([T, T + 4], 1)
B_N = torch.stack([G, G], 1)
C_ROW = torch.stack([G, G, G + 8, G + 8], 1)
C_COL = torch.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1)
# The permutation of the 8-wide k index in both products: column t holds
# SNP (or head) 2t, column t + 4 SNP 2t + 1.
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
TILE, WARPS = 128, 8


def geometry(k):
    """(KT, SQ, KS, NS) of csrc/dq_dp.cu's Geom for k."""
    KT = 4 if k <= 4 else (8 if k <= 8 else 16)
    return KT, max(KT, 8), (KT + 7) // 8, 1 if KT == 16 else 2


def tf32_rna(x):
    """cvt.rna.tf32.f32 on finite fp32: round to 10 stored mantissa bits,
    ties away from zero, the low 13 bits zero (integer ops on the bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32(x):
    """fp32 truncated to TF32: the low 13 bits cleared (the kernel's
    split_fast, for draw)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, to_tf32=tf32_rna):
    big = to_tf32(x)
    return big, to_tf32(x - big)


def to_matrix(regs, rows, cols, shape):
    """The matrix whose (rows[l, r], cols[l, r]) entry is regs[l, r]."""
    m = torch.zeros(shape, dtype=regs.dtype)
    m[rows, cols] = regs
    return m


def mma(c, a, b):
    """c + a b for per-lane fragments: c (32, 4), a (32, 4), b (32, 2). The
    eight products of an output summed exactly, rounded once to fp32."""
    A = to_matrix(a.double(), A_ROW, A_COL, (16, 8))
    Bm = to_matrix(b.double(), B_K, B_N, (8, 8))
    return c + (A @ Bm)[C_ROW, C_COL].float()


def mma3(c, a, b):
    (ab, as_), (bb, bs) = a, b
    return mma(mma(mma(c, as_, bb), ab, bs), ab, bb)


def unpack_word(u):
    m = u & (u >> 1) & 0x55555555
    return u & ~(m | (m << 1)) & 0xFFFFFFFF


def model_dq_dp(packed, q, P, cm, rw, g, masked, with_loss, n_blocks):
    """The kernel's walk over the plane; returns (dq, dP, loss, raw) with
    raw the (B, m_pad) plane of the first product."""
    B, k = q.shape
    m_pad = P.shape[1]
    KT, SQ, KS, NS = geometry(k)
    CH = 8 * NS
    words = torch.from_numpy(np.ascontiguousarray(packed).view("<u4")
                             .astype(np.int64))
    B16 = -(-B // 16) * 16
    sq = torch.zeros(B16, SQ)
    sq[:B, :k] = q
    sdq = torch.zeros(B16, SQ)
    srw = torch.zeros(B16)
    srw[:B] = rw if masked else 1.0
    dP = torch.full((k, m_pad), float("nan"))
    raw_plane = torch.full((B16, m_pad), float("nan"))
    loss = torch.zeros((), dtype=torch.float64)
    n_tiles = -(-m_pad // TILE)
    covered = []
    for blk in range(n_blocks):
        c_begin = n_tiles * blk // n_blocks * (TILE // CH)
        c_end = min(n_tiles * (blk + 1) // n_blocks * (TILE // CH),
                    m_pad // CH)
        for c in range(c_begin, c_end):
            s0 = c * CH
            covered.append(s0)
            w = s0 >> 4
            shift = (s0 & 15) * 2 + 4 * T
            pr, pd, cms = [], [], []
            for st in range(NS):
                s = s0 + 8 * st
                pr_h, pd_h = [], []
                for h in range(KS):
                    jr = 8 * h + 2 * T[:, None] + torch.arange(2)  # (32, 2)
                    jd = (8 * h + G)[:, None].expand(32, 2)
                    sd = s + 2 * T[:, None] + torch.arange(2)
                    pr_h.append(split(torch.where(
                        jr < k, P[jr.clamp(max=k - 1), s + G[:, None]], 0.0)))
                    pd_h.append(split(torch.where(
                        jd < k, P[jd.clamp(max=k - 1), sd], 0.0)))
                pr.append(pr_h)
                pd.append(pd_h)
                cms.append(cm[s + 2 * T[:, None] + torch.arange(2)] if masked
                           else torch.ones(32, 2))
            dp = torch.zeros(32, NS, KT, 2)
            for warp in range(WARPS):
                for r0 in range(warp * 16, B, WARPS * 16):
                    ra, rb = r0 + G, r0 + G + 8
                    ua, ub = (torch.where(r < B, unpack_word(
                        words[r.clamp(max=B - 1), w]), 0) >> shift
                        for r in (ra, rb))
                    qa = []
                    for h in range(KS):
                        cols = 8 * h + 2 * T
                        qa.append(split(torch.stack(
                            [sq[ra, cols], sq[rb, cols], sq[ra, cols + 1],
                             sq[rb, cols + 1]], 1)))
                    dqc = [torch.zeros(32, 4) for _ in range(KS)]
                    for st in range(NS):
                        s = s0 + 8 * st
                        # one accumulator a head slice, summed in order
                        c4 = sum(mma3(torch.zeros(32, 4), qa[h], pr[st][h])
                                 for h in range(KS))
                        raw_plane[C_ROW + r0, C_COL + s] = c4
                        fa, fb = ua >> (16 * st), ub >> (16 * st)
                        code = torch.stack([fa & 3, (fa >> 2) & 3, fb & 3,
                                            (fb >> 2) & 3], 1)
                        mrw = torch.stack(
                            [cms[st][:, 0] * srw[ra], cms[st][:, 1] * srw[ra],
                             cms[st][:, 0] * srw[rb], cms[st][:, 1] * srw[rb]],
                            1)
                        x = 0.5 * code.float()
                        rec = c4.clamp(0.0, 1.0)
                        d = (rec - x) / (rec * (1.0 - rec)).clamp_min(GRAD_EPS)
                        d = torch.where(c4 == rec, d, torch.zeros_like(d))
                        e = term_model(rec, code)  # bce_elem_code
                        if masked:
                            d, e = d * mrw, e * mrw
                        loss += e.double().sum()
                        pad = (C_ROW + r0) >= B
                        assert not d[pad].any() and not e[pad].any()
                        # The A fragment of draw is (c0, c2, c1, c3), with
                        # the SNP index permuted.
                        a_d = d[:, [0, 2, 1, 3]]
                        tile = to_matrix(d, C_ROW, C_COL, (16, 8))
                        assert torch.equal(
                            to_matrix(a_d, A_ROW, A_COL, (16, 8)),
                            tile[:, PERM])
                        for h in range(KS):  # one accumulator a step
                            dqc[h] = dqc[h] + mma3(torch.zeros(32, 4),
                                                   split(a_d, tf32),
                                                   pd[st][h])
                        qra, qrb = sq[ra, :KT], sq[rb, :KT]  # (32, KT)
                        for e_ in range(2):
                            dp[:, st, :, e_] += (qra * d[:, e_, None]
                                                 + qrb * d[:, e_ + 2, None])
                    for h in range(KS):
                        for e_ in range(2):
                            sdq[ra, 8 * h + 2 * T + e_] += dqc[h][:, e_]
                            sdq[rb, 8 * h + 2 * T + e_] += dqc[h][:, 2 + e_]
            # over the lanes that share t, then written with the factor g
            tot = dp.view(8, 4, NS, KT, 2).sum(0)  # (t, st, j, e)
            for st in range(NS):
                for e_ in range(2):
                    cols = s0 + 8 * st + 2 * torch.arange(4) + e_
                    dP[:, cols] = g * tot[:, st, :k, e_].T
    assert sorted(covered) == list(range(0, m_pad, CH))
    assert not sdq[:, k:].any() and not sdq[B:].any()
    return sdq[:B, :k], dP, loss.float(), raw_plane[:B]


def _inputs(seed, B, m_pad, k, grid, missing=True, M=None):
    """q (B, k), P (k, m_pad), packed, cm, rw. ``grid``: q and P on the
    2^-10 grid as in chip_smoke.py's phase 3 (P from U(-0.1, 1.1), column 0
    all zeros, column 1 all ones: raw exactly 0 and 1); else fp32 values,
    P in (0.05, 0.95). Columns from M on are padding: codes 0, P 0."""
    rng = np.random.default_rng(seed)
    M = m_pad if M is None else M
    G2 = rng.integers(0, 4 if missing else 3, size=(B, m_pad)).astype(np.uint8)
    G2[:, M:] = 0
    packed = pack_2bit_rows(G2, m_pad=m_pad)
    q = rng.dirichlet(np.ones(k), size=B)
    if grid:
        q = np.floor(q * 1024.0) / 1024.0
        q[:, -1] = 1.0 - q[:, :-1].sum(axis=1)
        P = np.round(rng.uniform(-0.1, 1.1, size=(k, m_pad)) * 1024) / 1024
        P[:, 0], P[:, 1] = 0.0, 1.0
    else:
        P = rng.uniform(0.05, 0.95, size=(k, m_pad))
    P[:, M:] = 0.0
    cm = (np.arange(m_pad) < M) * (rng.uniform(size=m_pad) > 0.1)
    rw = rng.uniform(size=B) > 0.2
    return [torch.from_numpy(np.ascontiguousarray(a).astype(np.float32))
            if a.dtype != np.uint8 else torch.from_numpy(a)
            for a in (packed, q, P, cm, rw)]


def _plane_inputs(seed, kind, B, M, k, missing, pad=16):
    """packed, q, P, cm, rw of a ``bce_plane`` kind, m_pad = M rounded up to
    16 plus ``pad`` padded columns (codes 0, P 0)."""
    rng = np.random.default_rng(seed)
    G2, q, P = bce_plane(rng, kind, B, M, k, missing)
    m_pad = -(-M // 16) * 16 + pad
    P = np.pad(P, ((0, 0), (0, m_pad - M)))
    cm = (np.arange(m_pad) < M) * (rng.uniform(size=m_pad) > 0.1)
    rw = rng.uniform(size=B) > 0.2
    return [torch.from_numpy(pack_2bit_rows(G2, m_pad=m_pad))] + [
        torch.from_numpy(np.ascontiguousarray(a).astype(np.float32))
        for a in (q, P, cm, rw)]


def _check_against_plain(got, packed, q, P, cm, rw, g, masked):
    dq, dP, loss = dq_dp_plain(packed, q, P, cm, rw, g, masked, True)
    mrw = cm[None] * rw[:, None] if masked else None
    draw, elem = draw_tile(q, P, unpack_dosage(packed), mrw, True)
    scales = (draw.abs() @ P.abs().T, (q * g).abs().T @ draw.abs(),
              elem.abs().sum())
    for name, a, b, sc in zip(("dq", "dP", "loss"), got, (dq, dP, loss),
                              scales):
        err = (a - b).abs()
        bound = 1e-5 * sc + 1e-6
        assert bool((err <= bound).all()), (
            f"{name}: max|d| {err.max():.3e}, worst |d|/bound "
            f"{(err / bound).max():.3f}")


def test_fragment_maps_cover_each_tile_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 8)), (B_K, B_N, (8, 8)),
                              (C_ROW, C_COL, (16, 8))):
        hit = torch.zeros(shape, dtype=torch.int64)
        hit.index_put_((rows.flatten(), cols.flatten()),
                       torch.ones(rows.numel(), dtype=torch.int64),
                       accumulate=True)
        assert bool((hit == 1).all())
    # c0..c3 of lane (g, t) read as the A fragment (c0, c2, c1, c3) sit at
    # columns (t, t, t + 4, t + 4) = SNPs (2t, 2t, 2t + 1, 2t + 1) of C.
    assert torch.equal(PERM[A_COL], C_COL[:, [0, 2, 1, 3]])
    assert torch.equal(A_ROW, C_ROW[:, [0, 2, 1, 3]])


def test_tf32_rounding_truncation_and_split():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-12, 13, size=4000),
        [0.0, -0.0, 1.0, 1e12, -3e-7]]).astype(np.float32))
    ulp = torch.ldexp(torch.ones(x.shape, dtype=torch.float64),
                      torch.frexp(x.double())[1] - 11)  # of TF32 at x
    rna, trunc = tf32_rna(x), tf32(x)
    for t in (rna, trunc):
        assert not (t.view(torch.int32) & 0x1FFF).any()  # 10 stored bits
    # nearest (ties away from zero) and toward zero, against fp64
    assert bool(((rna.double() - x.double()).abs() <= ulp / 2).all())
    assert bool((trunc.double().abs() <= x.double().abs()).all())
    assert bool(((trunc.double() - x.double()).abs() < ulp).all())
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)])
    assert tf32_rna(v).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -9)]
    assert tf32(v).tolist() == [1.0, -(1.0 + 2.0 ** -10)]
    for to_tf32, limit in ((tf32_rna, 2.0 ** -22), (tf32, 2.0 ** -20)):
        b, s = split(x, to_tf32)
        rel = ((b.double() + s.double() - x.double()).abs()
               / x.double().abs().clamp_min(1e-30))
        assert rel.max() <= limit
    grid = torch.round(torch.empty(1000).uniform_(-2, 2) * 1024) / 1024
    gb, gs = split(grid)
    assert torch.equal(gb, grid) and not gs.any()


@pytest.mark.parametrize("k", [2, 7, 8, 9, 16])
@pytest.mark.parametrize("B,m_pad,n_blocks", [(1, 272, 3), (17, 400, 3),
                                              (37, 272, 2)])
def test_model_matches_plain(k, B, m_pad, n_blocks):
    masked = B != 17
    packed, q, P, cm, rw = _inputs(B + k, B, m_pad, k, grid=False,
                                   missing=B != 1, M=m_pad - 20)
    g = 2.5
    dq, dP, loss, _ = model_dq_dp(packed, q, P, cm, rw, g, masked, True,
                                  n_blocks)
    _check_against_plain((dq, dP, loss), packed, q, P, cm, rw, g, masked)
    assert not dP[:, m_pad - 20:].any()  # padded SNP columns: exactly 0


@pytest.mark.parametrize("k", [2, 7, 8, 9, 16])
def test_model_is_exact_on_the_grid(k):
    B, m_pad = 15, 400
    packed, q, P, cm, rw = _inputs(k, B, m_pad, k, grid=True)
    dq, dP, loss, raw = model_dq_dp(packed, q, P, cm, rw, 1.0, True, True, 3)
    exact = q.double() @ P.double()
    assert torch.equal(raw.double(), exact)
    assert not raw[:, 0].any() and bool((raw[:, 1] == 1.0).all())
    _check_against_plain((dq, dP, loss), packed, q, P, cm, rw, 1.0, True)


@pytest.mark.parametrize("missing", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k", [3, 8, 10])
@pytest.mark.parametrize("plane", ["small_r", "edges", "near_one"])
def test_model_loss_on_the_adversarial_planes(plane, k, masked, missing):
    """K4's loss with K6's one-log term, on the planes where the term is
    hardest (r in [1e-9, 1e-3] at x = 0, r exactly 0 and 1 and clamped raw,
    r within 2^-20 of 1), at KT 4, 8 and 16: dq, dP and the loss within the
    rule of dq_dp_plain, and the loss within 1e-6 of the float64 clamped BCE
    of the model's own raw (over the sum of its absolute values)."""
    B, M = 21, 150
    packed, q, P, cm, rw = _plane_inputs(k + 10 * missing, plane, B, M, k,
                                         missing)
    dq, dP, loss, raw = model_dq_dp(packed, q, P, cm, rw, 1.0, masked, True,
                                    2)
    _check_against_plain((dq, dP, loss), packed, q, P, cm, rw, 1.0, masked)
    e64 = bce64(raw.clamp(0.0, 1.0), (2 * unpack_dosage(packed)).long())
    if masked:
        e64 = e64 * (cm[None] * rw[:, None]).double()
    assert abs(loss.item() - e64.sum().item()) <= \
        1e-6 * e64.abs().sum().item()
