"""The port's dq_dp / loss_dq_dp (K3 / K4) and dv (K5) against the JAX
package's Pallas kernels (ops/fused_step.py _dq_dp_call, _loss_dq_dp_call
and _dv_call, interpret mode on the CPU, exact division and fp32 operands
there), masked and unmasked, with and without ``no_missing``, and with a
loss cotangent g = 2.5; on a CUDA host, each kernel against its plain
version.

The JAX kernels take the tile-major batch and planar SNP order; the test
builds both as tests/test_fused.py:16-29 does and undoes the order on the
outputs. Tolerances are tests/test_fused.py's: loss rtol 2e-5, dq and dP
rtol 2e-4 / atol 2e-3, dV rtol 1e-4 / atol 1e-4.

The JAX package is imported inside the tests that compare with it, so that
the card's tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_port_dq_dp.py``.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.ops.dq_dp import MAX_K, dq_dp, dq_dp_plain
from neural_admixture_tpu_torch.ops.dv import dv, dv_plain
from neural_admixture_tpu_torch.ops.fused import draw_tile, unpack_dosage


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(seed, B=16, M=3000, m_pad=4096, K=5, missing=True):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4 if missing else 3, size=(B, M)).astype(np.uint8)
    packed = pack_2bit_rows(G, m_pad=m_pad)
    q = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    P = rng.uniform(-0.1, 1.1, size=(K, m_pad)).astype(np.float32)
    P[:, M:] = 0.0  # padded columns, as training keeps them
    cm = (np.arange(m_pad) < M).astype(np.float32)
    rw = (rng.uniform(size=B) > 0.2).astype(np.float32)
    return packed, q, P, cm, rw


def _jax_layout(packed, P, cm, rw):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import pack as pk
    from neural_admixture_tpu.ops.fused import pick_tb

    m_pad = packed.shape[1] * 4
    tiles = jnp.asarray(np.ascontiguousarray(
        pk.tiles_from_rows(pk.packed_view_u32(packed))))
    perm = pk.planar_perm(m_pad)
    return (tiles, jnp.asarray(P[:, perm]),
            jnp.asarray(cm[perm].reshape(1, -1)),
            jnp.asarray(rw.reshape(-1, 1)), pick_tb(packed.shape[0]),
            pk.inverse_perm(perm))


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("missing", [True, False])
@pytest.mark.parametrize("g", [1.0, 2.5])
def test_dq_dp_matches_jax_kernel(masked, missing, g):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import fused_step as fs

    packed, q, P, cm, rw = _case(0, missing=missing)
    tiles, Pp, cm2, rw2, tb, inv = _jax_layout(packed, P, cm, rw)
    (dq_j,), (dp_j,) = fs._dq_dp_call([jnp.asarray(q)], [Pp], tiles, cm2,
                                      rw2, jnp.float32(g), tb,
                                      no_missing=not missing, masked=masked)
    before = dq_dp.launches
    dq, dP, loss = dq_dp(*_port(packed, q, P, cm, rw), g, masked,
                         no_missing=not missing)
    assert dq_dp.launches == before and loss is None  # CPU: the plain path
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(dP.numpy(), np.asarray(dp_j)[:, inv],
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("missing", [True, False])
def test_loss_dq_dp_matches_jax_kernel(masked, missing):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import fused_step as fs

    packed, q, P, cm, rw = _case(1, missing=missing)
    tiles, Pp, cm2, rw2, tb, inv = _jax_layout(packed, P, cm, rw)
    loss_j, (dq_j,), (dp_j,) = fs._loss_dq_dp_call(
        [jnp.asarray(q)], [Pp], tiles, cm2, rw2, tb,
        no_missing=not missing, masked=masked)
    before = dq_dp.loss_launches
    dq, dP, loss = dq_dp(*_port(packed, q, P, cm, rw), 1.0, masked,
                         no_missing=not missing, with_loss=True)
    assert dq_dp.loss_launches == before
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(dP.numpy(), np.asarray(dp_j)[:, inv],
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("missing", [True, False])
def test_dv_matches_jax_kernel(missing):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import fused_step as fs

    packed, q, P, cm, rw = _case(2, missing=missing)
    tiles, _, _, _, tb, inv = _jax_layout(packed, P, cm, rw)
    dXp = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    want = np.asarray(fs._dv_call(tiles, jnp.asarray(dXp), tb,
                                  no_missing=not missing))[inv]
    before = dv.launches
    got = dv(*_port(packed, dXp), no_missing=not missing)
    assert dv.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk_snps", [64, 1000, 65536])
def test_plain_versions_do_not_depend_on_the_chunk(chunk_snps):
    packed, q, P, cm, rw = _case(4, B=5, M=700, m_pad=1024, K=3)
    pk, qt, Pt, cmt, rwt = _port(packed, q, P, cm, rw)
    x = unpack_dosage(pk)
    draw, elem = draw_tile(qt, Pt, x, cmt[None] * rwt[:, None], True)
    dq, dP, loss = dq_dp_plain(pk, qt, Pt, cmt, rwt, 2.5, True, True,
                               chunk_snps)
    torch.testing.assert_close(dq, draw @ Pt.T, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(dP, 2.5 * qt.T @ draw, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(loss, elem.sum(), rtol=1e-6, atol=0)
    dXp = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(dv_plain(pk, dXp, chunk_snps), x.T @ dXp,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "width", "k", "mask", "device"])
def test_dq_dp_rejects_bad_inputs(bad):
    packed = torch.zeros(3, 8, dtype=torch.uint8)
    q, P = torch.zeros(3, 2), torch.zeros(2, 32)
    cm, rw = torch.ones(32), torch.ones(3)
    if bad == "dtype":
        q = q.double()
    elif bad == "width":
        P = torch.zeros(2, 31)
    elif bad == "k":
        q, P = torch.zeros(3, MAX_K + 1), torch.zeros(MAX_K + 1, 32)
    elif bad == "mask":
        rw = torch.ones(4)
    else:
        P = P.to("meta")
    with pytest.raises(ValueError):
        dq_dp(packed, q, P, cm, rw, 1.0, True)


def _abs_bound(*sums):
    """|d| <= 1e-5 * (the plain version over absolute values) + 1e-6: fp32
    sums over the batch or the SNPs in another order."""
    return [1e-5 * s + 1e-6 for s in sums]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,K", [(9, 4112, 7), (96, 8208, 8),
                                   (37, 4144, 16), (600, 2064, 16),
                                   (1, 2080, 2), (15, 2064, 9),
                                   (17, 4144, 2), (600, 2080, 9),
                                   (900, 2064, 16)])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("with_loss,plane", [
    (False, "random"), (True, "random"), (True, "small_r"), (True, "edges"),
    (True, "near_one")])
@pytest.mark.parametrize("missing", [True, False])
def test_dq_dp_kernel_matches_plain_on_card(cuda_device, B, M, K, masked,
                                            with_loss, plane, missing):
    """B ragged against the kernel's 16-row groups, M against its 128-SNP
    tiles, every template (k <= 4, 8, 16) and, at B = 900 and k = 16, two
    launches. With the loss also on the adversarial planes of
    tests/test_torch_port_bce_sum.py ``bce_plane``, where the one-log term
    is hardest (raw is exact there, or far from the clamp edges)."""
    rng = np.random.default_rng(B)
    if plane == "random":
        packed = pack_2bit_rows(rng.integers(0, 4 if missing else 3,
                                             size=(B, M)).astype(np.uint8))
        q = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
        # raw inside (0.1, 0.9): no element near the clamp edges, where the
        # gradient amplifies the last bit of raw
        P = rng.uniform(0.1, 0.9, size=(K, M)).astype(np.float32)
    else:
        from test_torch_port_bce_sum import bce_plane  # tests/ on sys.path
        G, q, P = bce_plane(rng, plane, B, M, K, missing)
        packed = pack_2bit_rows(G)
    cm = (rng.uniform(size=M) > 0.1).astype(np.float32)
    rw = (rng.uniform(size=B) > 0.2).astype(np.float32)
    args = [t.to(cuda_device) for t in _port(packed, q, P, cm, rw)]
    got = dq_dp(*args, 2.5, masked, not missing, with_loss)
    torch.cuda.synchronize()
    want = dq_dp_plain(*args, 2.5, masked, with_loss)
    x = unpack_dosage(args[0])
    mrw = args[3][None] * args[4][:, None] if masked else None
    draw, elem = draw_tile(args[1], args[2], x, mrw, True)
    bounds = _abs_bound(draw.abs() @ args[2].abs().T,
                        2.5 * args[1].T @ draw.abs(), elem.abs().sum())
    for a, b, bound in zip(got, want, bounds):
        if a is not None:
            assert bool(((a - b).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,K", [(15, 2064, 2), (17, 4144, 8),
                                   (600, 2080, 9), (900, 2064, 16)])
def test_dq_dp_at_g_1_equals_loss_dq_dp_bit_for_bit(cuda_device, B, M, K):
    """K3 at g = 1 and K4 share their arithmetic: the split and merged
    training programs rest on it (ops/fused_step.py PlaneBCE)."""
    rng = np.random.default_rng(B + K)
    packed = pack_2bit_rows(rng.integers(0, 4, size=(B, M)).astype(np.uint8))
    q = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    P = rng.uniform(-0.1, 1.1, size=(K, M)).astype(np.float32)
    cm = (rng.uniform(size=M) > 0.1).astype(np.float32)
    rw = (rng.uniform(size=B) > 0.2).astype(np.float32)
    args = [t.to(cuda_device) for t in _port(packed, q, P, cm, rw)]
    for masked in (True, False):
        dq3, dP3, _ = dq_dp(*args, 1.0, masked)
        dq4, dP4, _ = dq_dp(*args, 1.0, masked, with_loss=True)
        assert torch.equal(dq3, dq4) and torch.equal(dP3, dP4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,D", [(1, 2064, 4), (37, 6160, 8),
                                   (130, 4144, 16), (37, 4112, 32),
                                   (300, 2064, 32), (33, 2064, 1),
                                   (800, 4096, 1), (2100, 2064, 8)])
@pytest.mark.parametrize("missing", [True, False])
def test_dv_kernel_matches_plain_on_card(cuda_device, B, M, D, missing):
    """B ragged against the kernel's 32-row k-steps and 256-row scale
    chunks, M against its 512-SNP tiles, D from 1 to 32 (one launch per 8
    columns), and B = 2100 past the 2048 rows of one launch."""
    rng = np.random.default_rng(B + D)
    G = rng.integers(0, 4 if missing else 3, size=(B, M)).astype(np.uint8)
    packed = torch.from_numpy(pack_2bit_rows(G)).to(cuda_device)
    dXp = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)
                           ).to(cuda_device)
    before = dv.launches
    got = dv(packed, dXp, no_missing=not missing)
    torch.cuda.synchronize()
    assert dv.launches == before + 1
    (bound,) = _abs_bound(dv_plain(packed, dXp.abs()))
    assert bool(((got - dv_plain(packed, dXp)).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,D", [(300, 1), (800, 8)])
def test_dv_kernel_on_a_spike_column_on_card(cuda_device, B, D):
    """Column 0 of dXp holds in every 256-row chunk (the kernel's scale
    chunk) one row 1000 times the rest, and that row's codes are 0 at 95%
    of the SNPs: the small rows' sum is what the chunk's scale cuts
    coarsest (tests/test_torch_port_dv_mma.py: three int8 pieces break the
    rule here, the kernel's four keep it)."""
    rng = np.random.default_rng(B + D)
    M = 4112
    G = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    dXp = rng.normal(size=(B, D)).astype(np.float32)
    dXp[:, 0] = rng.uniform(-1, 1, size=B)
    for c0 in range(0, B, 256):
        r = c0 + rng.integers(0, min(256, B - c0))
        dXp[r, 0] = 1000.0 * (1 if rng.uniform() < 0.5 else -1)
        G[r] = np.where(rng.uniform(size=M) < 0.05, 2, 0)
    packed = torch.from_numpy(pack_2bit_rows(G)).to(cuda_device)
    dXp = torch.from_numpy(dXp).to(cuda_device)
    got = dv(packed, dXp)
    torch.cuda.synchronize()
    (bound,) = _abs_bound(dv_plain(packed, dXp.abs()))
    assert bool(((got - dv_plain(packed, dXp)).abs() <= bound).all())
