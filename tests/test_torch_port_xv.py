"""The port's xv (X @ V from 2-bit rows) against the JAX package's xv Pallas
kernel (ops/fused_step.py _xv_call, interpret mode on the CPU) and a float64
numpy oracle; on a CUDA host, the CUDA kernel against its plain version.

Tolerance rtol 2e-5 / atol 2e-6: fp32 sums over a thousand SNPs, of
magnitude O(1), taken in another order.

The JAX package is imported inside the tests that compare with it, so that
the card's tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_port_xv.py``.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.ops.fused import unpack_dosage
from neural_admixture_tpu_torch.ops.xv import MAX_D, xv, xv_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(seed, N, M, D, missing):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4 if missing else 3, size=(N, M)).astype(np.uint8)
    packed, m_pad = pack_with_padding(G)
    V = np.zeros((m_pad, D), np.float32)
    V[:M] = rng.normal(size=(M, D)) * 0.05
    return G, packed, V


def _oracle(G, V):
    X = np.where(G == 3, 0.0, G / 2.0)
    return X @ V[:G.shape[1]].astype(np.float64)


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("missing", [True, False])
def test_xv_matches_jax_xv_kernel(missing, D):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import pack as pk
    from neural_admixture_tpu.ops.fused import pick_tb_wide
    from neural_admixture_tpu.ops.fused_step import _xv_call

    N = 37
    G, packed, V = _case(0, N, 1000, D, missing)
    m_pad = V.shape[0]
    B = -(-N // 8) * 8  # the Pallas kernel's 8-row quantum
    u32 = np.concatenate([pk.packed_view_u32(packed),
                          np.zeros((B - N, m_pad // 16), np.uint32)])
    tiles = jnp.asarray(np.ascontiguousarray(pk.tiles_from_rows(u32)))
    Vp = jnp.asarray(V[pk.planar_perm(m_pad)])
    want = np.asarray(_xv_call(tiles, Vp, pick_tb_wide(B),
                               no_missing=not missing))[:N]
    before = xv.launches
    got = xv(torch.from_numpy(packed), torch.from_numpy(V),
             no_missing=not missing)
    assert xv.launches == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and got.shape == (N, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("chunk_snps", [64, 1000, 65536])
@pytest.mark.parametrize("missing", [True, False])
def test_xv_plain_matches_float64_oracle(missing, chunk_snps):
    G, packed, V = _case(1, 21, 1000, 8, missing)
    got = xv_plain(torch.from_numpy(packed), torch.from_numpy(V), chunk_snps)
    np.testing.assert_allclose(got.numpy(), _oracle(G, V), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("scale", [True, False])
def test_unpack_dosage_matches_jax(scale):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import pack as pk

    G, packed, _ = _case(2, 5, 103, 1, True)
    got = unpack_dosage(torch.from_numpy(packed), scale=scale).numpy()
    want = np.asarray(pk.unpack_dosage_x(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want if scale else want * 2)


@pytest.mark.parametrize("bad", ["dtype", "rows", "wide", "device"])
def test_xv_rejects_bad_inputs(bad):
    packed = torch.zeros(3, 8, dtype=torch.uint8)
    V = torch.zeros(32, 4)
    if bad == "dtype":
        packed = packed.to(torch.int32)
    elif bad == "rows":
        V = torch.zeros(31, 4)
    elif bad == "wide":
        V = torch.zeros(32, MAX_D + 1)
    else:
        V = V.to("meta")
    with pytest.raises(ValueError):
        xv(packed, V)


def _spike(V, rng):
    """Column 0 of V with one entry of every 512-SNP chunk 1000 times the
    largest of the rest: the chunk's scale in the kernel is the spike's."""
    V[:, 0] = rng.uniform(-1.0, 1.0, size=V.shape[0]) * 0.05
    for c0 in range(0, V.shape[0], 512):
        V[c0 + rng.integers(0, min(512, V.shape[0] - c0)), 0] = 50.0
    return V


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,D,spike", [
    (37, 4000, 4, False), (130, 16400, 8, False), (9, 8192, 32, False),
    (17, 6160, 1, False), (800, 8192, 1, False), (300, 2064, 32, False),
    (130, 16384, 8, True), (15, 4000, 1, True), (33, 6160, 32, True)])
@pytest.mark.parametrize("missing", [True, False])
def test_xv_kernel_matches_plain_on_card(cuda_device, missing, B, M, D,
                                         spike):
    """Kernel vs plain on the card: |d| <= 1e-5 * sum|x||V| + 1e-6, at D
    from 1 to 32 (300 rows at D = 32 take two launches by rows), and with
    ``spike`` on V whose column 0 holds a 1000-fold spike in every 512-SNP
    chunk."""
    G, packed, V = _case(3, B, M, D, missing)
    if spike:
        V = _spike(V, np.random.default_rng(5))
    p = torch.from_numpy(packed).to(cuda_device)
    v = torch.from_numpy(V).to(cuda_device)
    before = xv.launches
    for no_missing in ([False, True] if not missing else [False]):
        got = xv(p, v, no_missing)
        torch.cuda.synchronize()
        want = xv_plain(p, v)
        bound = 1e-5 * xv_plain(p, v.abs()) + 1e-6
        assert bool(((got - want).abs() <= bound).all())
    assert xv.launches == before + (1 if missing else 2)
