"""The port's ``clamped_bce_sum`` (ops/loss.py) against the JAX package's
ops/loss.py under ``jax.value_and_grad``: torch's BCE semantics (the -100
log clamp, the 1e-12 gradient eps, the boundary-inclusive clamp gradient),
the column mask and the row weights, and zero cotangents for x and the
masks. Tolerance rtol 1e-6: elementwise fp32 math, summed over a few
hundred terms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_admixture_tpu.ops.loss import clamped_bce_sum as jbce
from neural_admixture_tpu_torch.ops.loss import clamped_bce_sum


def _case(seed, B=9, M=40):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-0.2, 1.2, size=(B, M)).astype(np.float32)
    x = rng.integers(0, 3, size=(B, M)).astype(np.float32) / 2
    # The edges: raw exactly 0 and 1 (inside, so the gradient passes),
    # rec = 0 and 1 against x on the other side (the -100 log clamp and the
    # 1e-12 gradient eps), and raw just outside [0, 1].
    raw[0, :6] = [0.0, 1.0, 0.0, 1.0, -1e-7, 1.0 + 1e-7]
    x[0, :6] = [0.5, 0.5, 1.0, 0.0, 0.5, 0.5]
    raw[1, :4] = [0.0, 0.0, 1.0, 1.0]
    x[1, :4] = [0.0, 1.0, 1.0, 0.0]
    col_mask = (rng.uniform(size=M) > 0.2).astype(np.float32)
    row_w = (rng.uniform(size=B) > 0.3).astype(np.float32)
    col_mask[:6] = 1.0
    row_w[:2] = 1.0
    return raw, x, col_mask, row_w


@pytest.mark.parametrize("masks", ["ones", "random"])
@pytest.mark.parametrize("g", [1.0, 2.5])
def test_value_and_grad_match_jax(masks, g):
    raw, x, cm, rw = _case(0)
    if masks == "ones":
        cm, rw = np.ones_like(cm), np.ones_like(rw)
    want, want_grads = jax.value_and_grad(
        lambda *a: g * jbce(*a), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (raw, x, cm, rw)))
    ts = [torch.tensor(a, requires_grad=True) for a in (raw, x, cm, rw)]
    got = clamped_bce_sum(*ts)
    (g * got).backward()
    np.testing.assert_allclose(got.item() * g, float(want), rtol=1e-6)
    np.testing.assert_allclose(ts[0].grad.numpy(), np.asarray(want_grads[0]),
                               rtol=1e-6, atol=0)
    for t, w in zip(ts[1:], want_grads[1:]):
        assert not np.asarray(w).any() and not t.grad.any()


def test_edges():
    """The hand-set edge elements, one by one (no masks)."""
    raw = np.array([[0.0, 1.0, 0.0, 1.0, -1e-7, 1.0 + 1e-7]], np.float32)
    x = np.array([[0.5, 0.5, 1.0, 0.0, 0.5, 0.5]], np.float32)
    r = torch.tensor(raw, requires_grad=True)
    loss = clamped_bce_sum(r, torch.tensor(x), torch.ones(6), torch.ones(1))
    loss.backward()
    grad = r.grad.numpy()[0]
    # rec = 0 or 1 with x strictly between: -100 clamp on one log term
    # and (rec - x) / 1e-12 as the gradient, passed through on the boundary.
    np.testing.assert_allclose(grad[:2], [-0.5e12, 0.5e12], rtol=1e-6)
    # Outside [0, 1]: no gradient.
    assert grad[4] == 0.0 and grad[5] == 0.0
    # rec = 0 against x = 1 and rec = 1 against x = 0: each 100.
    elem = [50.0, 50.0, 100.0, 100.0, 50.0, 50.0]
    np.testing.assert_allclose(loss.item(), sum(elem), rtol=1e-6)
