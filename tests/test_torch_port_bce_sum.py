"""The port's bce_sum (K6) and the indexed form of every packed-plane
kernel (K7) against the JAX package, on the CPU; on a CUDA host, each
kernel against its plain version (bce_sum also on the adversarial planes of
``bce_plane``) and each indexed kernel bit for bit against its gathered
form.

K6: the plain version against the JAX package's ``_loss_call`` (interpret
mode on the CPU), masked and unmasked, with and without missing codes, one
head and two (the port launches once per head and adds the heads in
order). K7: each indexed plain form (xv, dq_dp with and without the loss,
dv, bce_sum) against the JAX call with ``blk_idx`` (as
tests/test_indexed_step.py:35-86, resident rows in the JAX package's
tile-major layout and planar SNP order) and exactly equal to the port's
gathered form: the plain versions gather and then compute, so the two are
the same arithmetic.

Tolerances are tests/test_torch_port_dq_dp.py's: loss rtol 2e-5, dq and dP
rtol 2e-4 / atol 2e-3, Xp and dV rtol 1e-4 / atol 1e-4.

The JAX package is imported inside the tests that compare with it, so that
the card's tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_port_bce_sum.py``.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.ops.bce_sum import bce_sum, bce_sum_plain
from neural_admixture_tpu_torch.ops.dq_dp import dq_dp, dq_dp_plain
from neural_admixture_tpu_torch.ops.dv import dv
from neural_admixture_tpu_torch.ops.pack import batch_rows
from neural_admixture_tpu_torch.ops.xv import xv


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("missing", [True, False])
@pytest.mark.parametrize("ks", [(3,), (3, 5)])
def test_bce_sum_matches_jax_loss_call(masked, missing, ks):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import fused_step as fs
    from neural_admixture_tpu.ops import pack as pk
    from tests.test_torch_port_dq_dp import _case, _jax_layout

    packed, _, _, cm, rw = _case(5, missing=missing)
    rng = np.random.default_rng(6)
    qs = [rng.dirichlet(np.ones(k), size=16).astype(np.float32) for k in ks]
    Ps = [rng.uniform(-0.1, 1.1, size=(k, 4096)).astype(np.float32)
          for k in ks]
    for P in Ps:
        P[:, 3000:] = 0.0  # padded columns, as training keeps them
    tiles, _, cm2, rw2, tb, _ = _jax_layout(packed, Ps[0], cm, rw)
    perm = pk.planar_perm(4096)
    want = fs._loss_call([jnp.asarray(q) for q in qs],
                         [jnp.asarray(P[:, perm]) for P in Ps], tiles, cm2,
                         rw2, tb, no_missing=not missing, masked=masked)
    before = bce_sum.launches
    got = sum(bce_sum(*_port(packed, q, P, cm, rw), masked,
                      no_missing=not missing).item() for q, P in zip(qs, Ps))
    assert bce_sum.launches == before  # CPU: the plain path
    np.testing.assert_allclose(got, float(want), rtol=2e-5)


def test_bce_sum_plain_is_the_loss_of_dq_dp_plain():
    """Term for term and chunk for chunk: the split program logs the merged
    program's loss exactly on the CPU."""
    from tests.test_torch_port_dq_dp import _case
    packed, q, P, cm, rw = _port(*_case(7, B=9, M=700, m_pad=1024, K=4))
    for masked in (True, False):
        _, _, want = dq_dp_plain(packed, q, P, cm, rw, 1.0, masked, True,
                                 chunk_snps=256)
        got = bce_sum_plain(packed, q, P, cm, rw, masked, chunk_snps=256)
        assert got.item() == want.item()


def _indexed_case(seed, ks=(3, 5), N=64, M=300, D=4, blk=8, nbk=4):
    """Resident rows, a shuffled block index and per-batch operands."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    m_pad = -(-M // 2048) * 2048  # the JAX package's lane tile
    packed = pack_2bit_rows(G, m_pad=m_pad)
    blk_idx = rng.choice(N // blk, size=nbk, replace=False).astype(np.int32)
    B = nbk * blk
    return {
        "packed": packed, "blk_idx": blk_idx, "blk": blk, "B": B,
        "V": (rng.normal(size=(m_pad, D)) * 0.1).astype(np.float32),
        "qs": [rng.uniform(0.01, 0.99, size=(B, k)).astype(np.float32)
               for k in ks],
        "Ps": [rng.uniform(0.2, 0.8, size=(k, m_pad)).astype(np.float32)
               for k in ks],
        "dXp": rng.normal(size=(B, D)).astype(np.float32),
        "cm": (rng.uniform(size=m_pad) > 0.1).astype(np.float32),
        "rw": (rng.uniform(size=B) > 0.2).astype(np.float32),
    }


def _port_kernel_calls(c, name, masked=False, dev="cpu"):
    """(indexed call, gathered call) of one port kernel on case ``c``: each
    returns a tuple of outputs (one per head for the plane kernels)."""
    t = {k: torch.from_numpy(np.asarray(c[k])).to(dev)
         for k in ("packed", "blk_idx", "V", "dXp", "cm", "rw")}
    qs = [torch.from_numpy(q).to(dev) for q in c["qs"]]
    Ps = [torch.from_numpy(P).to(dev) for P in c["Ps"]]
    rows = batch_rows(t["blk_idx"], c["blk"])
    xb = t["packed"].index_select(0, rows).contiguous()
    ix = {"blk_idx": t["blk_idx"], "blk": c["blk"]}

    def plane(fn, **kw):
        def run(packed, idx):
            out = []
            for q, P in zip(qs, Ps):
                r = fn(packed, q, P, t["cm"], t["rw"], masked=masked,
                       **kw, **idx)
                out += [r] if torch.is_tensor(r) else [a for a in r
                                                       if a is not None]
            return tuple(out)
        return (lambda: run(t["packed"], ix)), (lambda: run(xb, {}))

    if name == "xv":
        return (lambda: (xv(t["packed"], t["V"], **ix),),
                lambda: (xv(xb, t["V"]),))
    if name == "dv":
        return (lambda: (dv(t["packed"], t["dXp"], **ix),),
                lambda: (dv(xb, t["dXp"]),))
    if name == "dq_dp":
        return plane(dq_dp, g=1.7)
    if name == "loss_dq_dp":
        return plane(dq_dp, with_loss=True)
    return plane(bce_sum)


KERNELS = ["xv", "dq_dp", "loss_dq_dp", "dv", "bce_sum"]


@pytest.mark.parametrize("name", KERNELS)
def test_indexed_plain_forms_match_jax_indexed_calls(name):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import fused_step as fs
    from neural_admixture_tpu.ops import pack as pk

    c = _indexed_case(3)
    m_pad = c["packed"].shape[1] * 4
    perm = pk.planar_perm(m_pad)
    inv = pk.inverse_perm(perm)
    resident = jnp.asarray(pk.tiles_from_rows(pk.packed_view_u32(
        c["packed"])))
    bi, blk = jnp.asarray(c["blk_idx"]), c["blk"]
    qs = [jnp.asarray(q) for q in c["qs"]]
    Ps = [jnp.asarray(P[:, perm]) for P in c["Ps"]]
    if name == "xv":
        want = [np.asarray(fs._xv_call(resident, jnp.asarray(c["V"][perm]),
                                       blk, blk_idx=bi))]
    elif name == "dv":
        want = [np.asarray(fs._dv_call(resident, jnp.asarray(c["dXp"]), blk,
                                       blk_idx=bi))[inv]]
    elif name == "dq_dp":
        dqs, dps = fs._dq_dp_call(qs, Ps, resident, None, None,
                                  jnp.float32(1.7), blk, masked=False,
                                  blk_idx=bi)
        want = [a for dq, dp in zip(dqs, dps)
                for a in (np.asarray(dq), np.asarray(dp)[:, inv])]
    elif name == "loss_dq_dp":
        loss, dqs, dps = fs._loss_dq_dp_call(qs, Ps, resident, None, None,
                                             blk, masked=False, blk_idx=bi)
        want = [float(loss)] + [a for dq, dp in zip(dqs, dps)
                                for a in (np.asarray(dq),
                                          np.asarray(dp)[:, inv])]
    else:
        want = [float(fs._loss_call(qs, Ps, resident, None, None, blk,
                                    masked=False, blk_idx=bi))]
    indexed, gathered = _port_kernel_calls(c, name)
    got, ref = indexed(), gathered()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if name in ("loss_dq_dp", "bce_sum"):
        # one loss per head here, one summed over the heads there
        losses = [g.item() for g in got if g.dim() == 0]
        np.testing.assert_allclose(sum(losses), want[0], rtol=2e-5)
        got, want = [g for g in got if g.dim()], want[1:]
    rtol, atol = ((1e-4, 1e-4) if name in ("xv", "dv") else (2e-4, 2e-3))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("blk,nbk", [(1, 21), (16, 3)])
@pytest.mark.parametrize("masked", [True, False])
def test_indexed_plain_forms_equal_gathered(blk, nbk, masked):
    """Every form, masked or not, at blocks of one row and of 16, over a
    resident array larger than the batch."""
    c = _indexed_case(4, ks=(2, 7), N=96, M=500, D=8, blk=blk, nbk=nbk)
    for name in KERNELS:
        indexed, gathered = _port_kernel_calls(c, name, masked)
        for a, b in zip(indexed(), gathered()):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("bad", ["dtype", "k", "mask", "blk_idx_dtype",
                                 "blk_idx_range", "blk"])
def test_bce_sum_rejects_bad_inputs(bad):
    packed = torch.zeros(4, 8, dtype=torch.uint8)
    q, P = torch.zeros(4, 2), torch.zeros(2, 32)
    cm, rw = torch.ones(32), torch.ones(4)
    kw = {}
    if bad == "dtype":
        q = q.double()
    elif bad == "k":
        q, P = torch.zeros(4, 17), torch.zeros(17, 32)
    elif bad == "mask":
        rw = torch.ones(3)
    elif bad == "blk_idx_dtype":
        kw = {"blk_idx": torch.zeros(2, dtype=torch.int64), "blk": 2}
    elif bad == "blk_idx_range":
        kw = {"blk_idx": torch.tensor([0, 2], dtype=torch.int32), "blk": 2}
    else:
        kw = {"blk_idx": torch.tensor([0, 1], dtype=torch.int32), "blk": 0}
    with pytest.raises(ValueError):
        bce_sum(packed, q, P, cm, rw, True, **kw)


PLANES = ["random", "small_r", "edges", "near_one"]


def bce_plane(rng, kind, B, M, k, missing):
    """(G (B, M) uint8 codes, q (B, k), P (k, M)) of one kind of decoder
    plane, fp32:

    * random: codes 0-2 (0-3 with ``missing``), Dirichlet q, P in (0.1, 0.9);
    * small_r: x = 0 everywhere (codes 0, or 0 and 3), P = 10^U(-9, -3), so
      r = q P in [1e-9, 1e-3], where log(1 - r) in fp32 would lose the loss
      and only log1p keeps it;
    * edges: q on the 2^-10 grid with rows summing to 1; P columns by turns
      all 0 (r = 0, as the padded columns), all 1 (r = 1 exactly) and on
      the grid in (-0.1, 1.1) (raw outside [0, 1] clamps), every code;
    * near_one: one-hot q rows, P = 1 - u 2^-24 for u in 1..16, so that
      r = P exactly within 2^-20 of 1, code 2 (with ``missing``, a quarter
      code 3).
    """
    hi = 4 if missing else 3
    if kind == "random":
        G = rng.integers(0, hi, size=(B, M))
        q = rng.dirichlet(np.ones(k), size=B)
        P = rng.uniform(0.1, 0.9, size=(k, M))
        return (G.astype(np.uint8), q.astype(np.float32),
                P.astype(np.float32))
    q = rng.dirichlet(np.ones(k), size=B)
    if kind == "small_r":
        G = 3 * (rng.uniform(size=(B, M)) < 0.25) if missing else \
            np.zeros((B, M))
        P = 10.0 ** rng.uniform(-9, -3, size=(k, M))
    elif kind == "edges":
        G = rng.integers(0, hi, size=(B, M))
        q = np.floor(q * 1024.0) / 1024.0
        q[:, -1] = 1.0 - q[:, :-1].sum(axis=1)
        P = np.round(rng.uniform(-0.1, 1.1, size=(k, M)) * 1024) / 1024
        P[:, 0::3], P[:, 1::3] = 0.0, 1.0
    else:
        G = np.where(rng.uniform(size=(B, M)) < (0.25 if missing else 0.0),
                     3, 2)
        q = np.eye(k)[np.arange(B) % k]
        P = 1.0 - rng.integers(1, 17, size=(k, M)) * 2.0 ** -24
    return (G.astype(np.uint8), q.astype(np.float32), P.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("B,M,K", [(9, 4112, 1), (96, 8208, 7),
                                   (37, 4144, 16), (600, 2064, 16)])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("missing", [True, False])
def test_bce_sum_kernel_matches_plain_on_card(cuda_device, B, M, K, masked,
                                              missing, plane):
    rng = np.random.default_rng(B + K)
    G, q, P = bce_plane(rng, plane, B, M, K, missing)
    cm = (rng.uniform(size=M) > 0.1).astype(np.float32)
    rw = (rng.uniform(size=B) > 0.2).astype(np.float32)
    args = [t.to(cuda_device) for t in _port(pack_2bit_rows(G), q, P, cm, rw)]
    before = bce_sum.launches
    got = bce_sum(*args, masked, not missing)
    torch.cuda.synchronize()
    assert bce_sum.launches == before + 1
    want = bce_sum_plain(*args, masked)
    # fp32 sums over ~10^5 positive terms in another order
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("B,M,K", [(9, 4112, 3), (96, 8208, 8),
                                   (600, 2064, 10)])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("missing", [True, False])
def test_loss_dq_dp_loss_equals_bce_sum_on_card(cuda_device, B, M, K, masked,
                                               missing, plane):
    """K4 (dq_dp with the loss) and K6 add the same one-log term of every
    element (csrc/bce.cuh), in other orders: the merged and the split
    programs' losses agree within the rule of fp32 sums, at KT 4, 8, 16."""
    rng = np.random.default_rng(B + K + 1)
    G, q, P = bce_plane(rng, plane, B, M, K, missing)
    cm = (rng.uniform(size=M) > 0.1).astype(np.float32)
    rw = (rng.uniform(size=B) > 0.2).astype(np.float32)
    args = [t.to(cuda_device) for t in _port(pack_2bit_rows(G), q, P, cm, rw)]
    k6 = bce_sum(*args, masked, not missing)
    _, _, k4 = dq_dp(*args, 1.0, masked, not missing, True)
    torch.cuda.synchronize()
    assert abs(k4.item() - k6.item()) <= 1e-5 * abs(k6.item()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 8, 10])
def test_loss_dq_dp_term_is_bce_elem_code_bit_for_bit_on_card(cuda_device,
                                                              K):
    """K4's term of each element is K6's bce_elem_code, bit for bit. Row b
    holds code b (0-3) and a one-hot q at head b % K; P holds values of at
    most 11 significant bits in [0, 1], which 3xTF32 keeps whole, so raw is
    that value exactly. A mask that keeps one element at a time makes K4's
    loss that element's term added to +0 (the others add +0 too; a term of
    -0, code 2 at r = 1, reads +0), which is held against bce_sum's term
    check (na_bce_sum_term_check) on the same (r, code)."""
    import ctypes

    from neural_admixture_tpu_torch import _build
    rng = np.random.default_rng(K)
    M = 64
    r = np.concatenate([
        [0.0, 1.0, 0.5, 0.25, 0.75, 1 - 2.0 ** -11, 1 - 2.0 ** -10,
         683 * 2.0 ** -11, 2.0 ** -126, 3 * 2.0 ** -100, 2.0 ** -24],
        rng.integers(1024, 2048, size=M - 11)
        * 2.0 ** -(11 + rng.integers(0, 110, size=M - 11))])
    r = r.astype(np.float32)
    P = np.tile(r, (K, 1))
    q = np.eye(K, dtype=np.float32)[np.arange(4) % K]
    G = np.tile(np.arange(4, dtype=np.uint8)[:, None], (1, M))
    args = [t.to(cuda_device) for t in _port(
        pack_2bit_rows(G), q, P, np.zeros(M, np.float32),
        np.zeros(4, np.float32))]
    got = torch.empty(4, M, device=cuda_device)
    for b in range(4):
        args[4].zero_()
        args[4][b] = 1.0
        for m in range(M):
            args[3].zero_()
            args[3][m] = 1.0
            got[b, m] = dq_dp(*args, 1.0, True, False, True)[2]
    rec = torch.from_numpy(np.tile(r, 4)).to(cuda_device)
    code = torch.arange(4, device=cuda_device,
                        dtype=torch.int32).repeat_interleave(M)
    want = torch.empty_like(rec)
    lib = _build.load("bce_sum")
    vp = ctypes.c_void_p
    lib.na_bce_sum_term_check.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.na_bce_sum_term_check.restype = ctypes.c_int
    assert lib.na_bce_sum_term_check(
        rec.data_ptr(), code.data_ptr(), want.data_ptr(), rec.numel(),
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    want = want + 0.0  # -0 + 0 = +0
    bad = got.flatten().view(torch.int32) != want.view(torch.int32)
    assert not bad.any(), (rec[bad].tolist(), code[bad].tolist(),
                           got.flatten()[bad].tolist(), want[bad].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("name,masked", [("xv", False), ("dv", False)] + [
    (name, masked) for name in KERNELS[1:] if name != "dv"
    for masked in (True, False)])
@pytest.mark.parametrize("blk,nbk", [(1, 37), (16, 5)])
def test_indexed_kernels_equal_gathered_on_card(cuda_device, name, masked,
                                                blk, nbk):
    c = _indexed_case(8, ks=(3, 10), N=640, M=3000, D=8, blk=blk, nbk=nbk)
    indexed, gathered = _port_kernel_calls(c, name, masked, cuda_device)
    counter = {"xv": xv, "dv": dv, "bce_sum": bce_sum}.get(name, dq_dp)
    attr = ("indexed_loss_launches" if name == "loss_dq_dp"
            else "indexed_launches")
    before = getattr(counter, attr)
    got = indexed()
    torch.cuda.synchronize()
    assert getattr(counter, attr) > before
    for a, b in zip(got, gathered()):
        assert torch.equal(a, b), name
