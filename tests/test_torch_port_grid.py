"""The port's (data, snp) grid against the JAX package's mesh, on the CPU.

Grids of CPU ranks over gloo start inside the tests (``spawn_grid`` with a
``file://`` rendezvous under tmp_path); the JAX package runs in the test
process on the 8 virtual CPU devices of tests/conftest.py. Each grid shape
is spawned once (a module fixture) and its ranks run every check that
shape serves.

  * the host-row helpers (rows_per_process, host_sample_shard,
    shard_row_order) and the stratified plan against the JAX functions;
  * one sharded step's loss and gradients on (2, 2), (4, 1) and (1, 2)
    grids, unsupervised and supervised, against the JAX package's
    make_sharded_loss_and_grad (XLA path) on meshes of the same shapes,
    and against the port's one-rank fused_training_loss: the loss within
    rtol 1e-5, the gradients within rtol 2e-4, atol 2e-3, as
    tests/test_sharded_step.py:80-86 holds the JAX step;
  * PsumSnp's gradient on a 1 x 2 grid, infer_q_sharded on a 2 x 2 grid
    against the JAX package's (rtol 2e-5, atol 2e-6), and the rows= RSVD
    on a 4 x 1 grid against the one-rank RSVD per component (as
    tests/test_torch_port_train.py test_rsvd_matches_jax holds it).

This module imports neither JAX nor tests.conftest at its top: the ranks
import it to find their function.
"""
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.io.writers import _flatten, _unflatten
from neural_admixture_tpu_torch.models import qp
from neural_admixture_tpu_torch.ops.fused_step import fused_training_loss
from neural_admixture_tpu_torch.ops.loss import softmax_cross_entropy_sum
from neural_admixture_tpu_torch.parallel import distributed as tdist
from neural_admixture_tpu_torch.parallel.grid import (
    param_specs, shard_params, unshard_params)
from neural_admixture_tpu_torch.train import engine as tengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 2), (4, 1), (1, 2)]
B, M_PAD, K, D, H, CE_W = 16, 8192, 4, 4, 16, 7.0
N_INFER = 37  # a ragged tail: data rows of 19 and 18 rows


def _inputs(seed=0):
    """tests/test_sharded_step.py's _setup, in numpy, with the JAX
    package's initial parameters."""
    import jax
    from neural_admixture_tpu.models import qp as jqp
    rng = np.random.default_rng(seed)
    M = M_PAD - 100
    G = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    V = rng.normal(size=(M_PAD, D)).astype(np.float32) * 0.1
    P_init = rng.uniform(0.2, 0.8, size=(K, M_PAD)).astype(np.float32)
    params = jax.tree.map(np.asarray, jqp.init_params(
        jax.random.PRNGKey(seed), V, P_init, H, [K]))
    G_inf = rng.integers(0, 4, size=(N_INFER, M)).astype(np.uint8)
    return {"params": params, "packed": pack_2bit_rows(G, m_pad=M_PAD),
            "col_mask": (np.arange(M_PAD) < M).astype(np.float32),
            "row_w": (rng.uniform(size=B) > 0.1).astype(np.float32),
            "pops": rng.integers(0, K, size=B).astype(np.int64),
            "packed_inf": pack_2bit_rows(G_inf, m_pad=M_PAD)}


def _grads(model) -> dict:
    """A model's gradients in the JAX package's flat layout."""
    return {name: qp.to_layout(p.grad, transpose)
            for name, p, transpose in qp.param_layout(model)}


def _grid_checks(grid, inp):
    """What a rank of each grid shape returns: its step (both modes), and
    PsumSnp's gradient on 1 x 2 and the sharded Q pass on 2 x 2."""
    from neural_admixture_tpu_torch.parallel.sharded_step import (
        PsumSnp, infer_q_sharded, make_sharded_loss_and_grad)
    Dn, S, d, s = grid.n_data, grid.n_snp, grid.d, grid.s
    bl, wl = B // Dn, M_PAD // 4 // S
    rows, cols = slice(d * bl, (d + 1) * bl), slice(s * wl, (s + 1) * wl)
    xb = torch.from_numpy(np.ascontiguousarray(inp["packed"][rows, cols]))
    out = {"at": (d, s)}
    for supervised in (False, True):
        model = qp.params_from_numpy(shard_params(inp["params"], S, s), [K])
        lag = make_sharded_loss_and_grad(grid, supervised, CE_W)
        loss = lag(model, xb, torch.from_numpy(inp["row_w"][rows]),
                   torch.from_numpy(inp["col_mask"][4 * s * wl:
                                                    4 * (s + 1) * wl]),
                   torch.from_numpy(inp["pops"][rows]), True, False, True)
        out[supervised] = (float(loss), _grads(model))
    if (Dn, S) == (1, 2):
        c = torch.from_numpy(np.random.default_rng(10 + s).normal(
            size=(5, 3)).astype(np.float32))
        x = torch.from_numpy(np.random.default_rng(20 + s).normal(
            size=(5, 3)).astype(np.float32)).requires_grad_(True)
        y = PsumSnp.apply(x, grid)
        (y * c).sum().backward()
        out["psum"] = (x.detach().numpy(), y.detach().numpy(), c.numpy(),
                       x.grad.numpy())
    if (Dn, S) == (4, 1):
        from neural_admixture_tpu_torch.infer import rows_of_data_row
        from neural_admixture_tpu_torch.ops.rsvd import rsvd
        start, end, _ = rows_of_data_row(N_INFER, grid)
        out["rsvd"] = rsvd(torch.from_numpy(inp["packed_inf"][start:end]),
                           N_INFER, M_PAD - 100, 5, 7,
                           block_bytes=4 * M_PAD * 4, rows=(start, end),
                           grid=grid)
    if (Dn, S) == (2, 2):
        from neural_admixture_tpu_torch.infer import rows_of_data_row
        enc = {k: v for k, v in inp["params"].items() if k != "decoders"}
        model = qp.params_from_numpy(shard_params(enc, S, s), [K])
        start, end, _ = rows_of_data_row(N_INFER, grid)
        blk = torch.from_numpy(np.ascontiguousarray(
            inp["packed_inf"][start:end, cols]))
        out["infer"] = infer_q_sharded(model, grid, blk, end - start,
                                       batch=8)[f"k{K}"]
    return out


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    inp = _inputs()
    runs = {}
    for shape in SHAPES:
        rdv = tmp_path_factory.mktemp("rdv") / "rdv"
        runs[shape] = tdist.spawn_grid(_grid_checks, *shape, args=(inp,),
                                       init_method=f"file://{rdv}")
    return inp, runs


def _full_grads(results, S):
    """The whole gradient dict from the ranks of data row 0, in order."""
    return _flatten(unshard_params([_unflatten(results[s][1])
                                    for s in range(S)]))


def _jax_step(inp, shape, supervised):
    import jax
    from neural_admixture_tpu.parallel.mesh import make_mesh
    from neural_admixture_tpu.parallel.sharded_step import (
        make_sharded_loss_and_grad as jmake)
    mesh = make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    fn = jmake(mesh, inp["params"], supervised, CE_W, use_pallas=False)
    loss, grads = jax.jit(fn)(inp["params"], inp["packed"], inp["row_w"],
                              inp["col_mask"], inp["pops"].astype(np.int32))
    return float(loss), _flatten(jax.tree.map(np.asarray, grads))


def _one_rank_step(inp, supervised):
    model = qp.params_from_numpy(inp["params"], [K])
    rw = torch.from_numpy(inp["row_w"])
    loss, qs = fused_training_loss(model, torch.from_numpy(inp["packed"]),
                                   torch.from_numpy(inp["col_mask"]), rw,
                                   True, False, True)
    if supervised:
        loss = loss + CE_W * softmax_cross_entropy_sum(
            qs[f"k{K}"], torch.from_numpy(inp["pops"]), rw)
    loss.backward()
    return loss.item(), _grads(model)


def _assert_step_close(loss, grads, want_loss, want_grads):
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(grads) == set(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(grads[name], want, rtol=2e-4, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("supervised", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_jax(grid_runs, shape, supervised):
    inp, runs = grid_runs
    results = [r[supervised] for r in runs[shape]]
    losses = {loss for loss, _ in results}
    assert len(losses) == 1, losses  # the world's sum, on every rank
    want_loss, want_grads = _jax_step(inp, shape, supervised)
    _assert_step_close(results[0][0], _full_grads(results, shape[1]),
                       want_loss, want_grads)


@pytest.mark.parametrize("supervised", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_one_rank(grid_runs, shape, supervised):
    inp, runs = grid_runs
    results = [r[supervised] for r in runs[shape]]
    want_loss, want_grads = _one_rank_step(inp, supervised)
    _assert_step_close(results[0][0], _full_grads(results, shape[1]),
                       want_loss, want_grads)
    # Every data row ends its step with the same reduced gradients.
    S = shape[1]
    for r, res in enumerate(results):
        for name, g in res[1].items():
            np.testing.assert_array_equal(g, results[r % S][1][name])


def test_psum_snp_gradient_sums_the_cotangents(grid_runs):
    """Forward: the sum of the snp group's partials. Backward: the sum of
    the ranks' cotangents, not this rank's own (plain autograd through an
    all_reduce would give c_s alone)."""
    _, runs = grid_runs
    (x0, y0, c0, g0), (x1, y1, c1, g1) = [r["psum"] for r in runs[(1, 2)]]
    for y in (y0, y1):
        np.testing.assert_allclose(y, x0 + x1, rtol=1e-6)
    for g in (g0, g1):
        np.testing.assert_allclose(g, c0 + c1, rtol=1e-6)
    assert not np.allclose(g0, c0)


def test_infer_q_sharded_matches_jax(grid_runs):
    import jax
    from neural_admixture_tpu.parallel.mesh import make_mesh
    from neural_admixture_tpu.parallel.mesh import shard_params as jshard
    from neural_admixture_tpu.parallel.sharded_step import (
        infer_q_sharded as jinfer)
    inp, runs = grid_runs
    enc = {k: v for k, v in inp["params"].items() if k != "decoders"}
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    want = np.asarray(jinfer(mesh, jshard(jax.tree.map(np.asarray, enc),
                                          mesh), inp["packed_inf"], N_INFER,
                             False, batch=8)[f"k{K}"])
    for r in runs[(2, 2)]:
        assert r["infer"].shape == (N_INFER, K)
        np.testing.assert_allclose(r["infer"], want, rtol=2e-5, atol=2e-6)


def test_rsvd_over_data_rows_matches_one_rank(grid_runs):
    """Data rows of 10, 10, 10 and 7 rows: the sketch gathered, Q^T A
    summed over the data group."""
    from neural_admixture_tpu_torch.ops.rsvd import rsvd
    inp, runs = grid_runs
    want = rsvd(torch.from_numpy(inp["packed_inf"]), N_INFER, M_PAD - 100,
                5, 7, block_bytes=4 * M_PAD * 4)
    for r in runs[(4, 1)]:
        for c in range(5):
            np.testing.assert_allclose(r["rsvd"][c], want[c], rtol=0,
                                       atol=2e-4 * np.abs(want[c]).max(),
                                       err_msg=f"component {c}")


@pytest.mark.parametrize("N,d_sz,n_proc,quantum", [
    (105, 2, 2, 1), (120, 2, 2, 32), (100, 4, 2, 64), (7, 4, 4, 1),
    (4096, 8, 4, 128)])
def test_row_helpers_match_jax(monkeypatch, N, d_sz, n_proc, quantum):
    import jax
    from neural_admixture_tpu.parallel import distributed as jdist
    from neural_admixture_tpu.train import engine as jengine
    rows_pp = tdist.rows_per_process(N, d_sz, n_proc, quantum)
    assert rows_pp == jdist.rows_per_process(N, d_sz, n_proc, quantum)
    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    for p in range(n_proc):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        assert tdist.host_sample_shard(N, d_sz, quantum, p, n_proc) == \
            jdist.host_sample_shard(N, d_sz, quantum)
    np.testing.assert_array_equal(
        tengine.shard_row_order(N, 5, n_proc, rows_pp),
        jengine.shard_row_order(N, 5, n_proc, rows_pp))


class _Mesh:
    """What the JAX engine's geometry reads of a mesh."""

    def __init__(self, d_sz):
        self.shape = {"data": d_sz}


@pytest.mark.parametrize("N,batch,blk,d_sz", [
    (100, 40, 16, 2), (120, 64, 16, 2), (105, 65, 1, 2), (105, 800, 1, 4),
    (4096, 800, 16, 2), (37, 10, 4, 2)])
def test_geometry_and_stratified_plan_match_jax(N, batch, blk, d_sz):
    """block_geometry on a d_sz-wide data axis (the JAX package's XLA path)
    and _stratified_plan from the same permutations."""
    import jax
    from neural_admixture_tpu.train import engine as jengine
    mesh = _Mesh(d_sz)
    b_round, nb, b_rem, n_rows = tengine.block_geometry(N, batch, blk, d_sz)
    if blk > 1:
        assert (b_round, nb, b_rem, n_rows) == jengine.block_geometry(
            N, batch, False, mesh, blk)
    else:
        # The JAX engine hands its plans min(batch_size, N).
        jb_round, jnb, jb_rem, _ = jengine._batch_plan(
            N, min(batch, N), False, mesh, 1, None, None)
        assert (b_round, nb, b_rem) == (jb_round, jnb, jb_rem)
        n_rows = d_sz * tdist.rows_per_process(N, d_sz, d_sz)
    key = jax.random.PRNGKey(3)
    want = jengine._stratified_plan(key, d_sz, blk, N, n_rows, b_round, nb,
                                    b_rem)
    got = tengine.stratified_plan(
        lambda p, n: np.asarray(jax.random.permutation(
            jax.random.fold_in(key, p), n)),
        d_sz, blk, N, n_rows, b_round, nb, b_rem)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_param_specs_follow_the_jax_mesh_layout():
    """V by rows and P by columns over snp, the rest replicated; shard and
    unshard are inverses."""
    from neural_admixture_tpu.parallel.mesh import param_specs as jspecs
    params = qp.init_params(torch.Generator().manual_seed(0),
                            np.ones((64, 3), np.float32),
                            np.full((5, 64), 0.5, np.float32), 8, [2, 3])
    specs, want = param_specs(params), jspecs(params)
    flat = _flatten(params)
    for name in flat:
        spec, jspec = specs, want
        for key in name.split("/"):
            spec, jspec = spec[key], jspec[key]
        assert tuple(spec) == tuple(jspec), name
    parts = [shard_params(params, 4, s) for s in range(4)]
    assert parts[1]["V"].shape == (16, 3)
    assert parts[3]["decoders"]["k3"].shape == (3, 16)
    for name, a in _flatten(unshard_params(parts)).items():
        np.testing.assert_array_equal(a, flat[name])


def test_parallel_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import neural_admixture_tpu_torch.parallel.distributed\n"
            "import neural_admixture_tpu_torch.parallel.sharded_step\n"
            "import neural_admixture_tpu_torch.train.run\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'neural_admixture_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_partial_multihost_configuration_raises(monkeypatch):
    """The JAX package's rule (tests/test_multihost.py:70-92): a partial
    NA_TPU_* set raises instead of letting every host act as the master."""
    for var in ("NA_TPU_COORDINATOR", "NA_TPU_NUM_PROCESSES",
                "NA_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.maybe_initialize_distributed() is None
    for env in ({"NA_TPU_COORDINATOR": "127.0.0.1:1"},
                {"NA_TPU_PROCESS_ID": "1"},
                {"NA_TPU_COORDINATOR": "127.0.0.1:1",
                 "NA_TPU_NUM_PROCESSES": "2"}):
        with monkeypatch.context() as m:
            for var, value in env.items():
                m.setenv(var, value)
            with pytest.raises(ValueError, match="Incomplete multi-process"):
                tdist.maybe_initialize_distributed()
    monkeypatch.setenv("NA_TPU_COORDINATOR", "10.0.0.1:5000")
    monkeypatch.setenv("NA_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("NA_TPU_PROCESS_ID", "1")
    assert tdist.maybe_initialize_distributed() == tdist.Hosts(
        "10.0.0.1:5000", 2, 1)


def test_package_data_ships_the_native_source():
    """A wheel carries native/bed_decode.cpp, so an installed port builds
    its host decoder instead of reading through the NumPy twins."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert data["neural_admixture_tpu_torch.native"] == ["*.cpp"]
    assert os.path.exists(os.path.join(
        REPO, "neural_admixture_tpu_torch", "native", "bed_decode.cpp"))
