"""Host streaming on a grid of CPU ranks, against the resident grid and the
JAX engine.

  * a streamed 2 x 2 grid (sample_block 16) against the resident 2 x 2 grid
    under NA_TPU_STRATIFIED=1, from the JAX package's init and stratified
    plans: Q, P, every parameter and the logged loss bit for bit on every
    rank; the resident grid against the JAX engine emulating two processes
    on a (2, 2) mesh under NA_TPU_STRATIFIED=1 (tests/conftest.py's
    trajectory rule), as tests/test_stream.py:346 and
    tests/test_multihost.py:163 hold the JAX package's streamed run to it;
  * 2 x 1 grids with sample_block 1, streamed against resident bit for bit:
    one K, K = 2 and 3 at once, supervised, and the split program;
  * the staged grid ``infer_q_mesh`` against the sharded pass over the
    block uploaded whole, bit for bit; each rank's stager gathers on its
    share of the host's cores;
  * the CLI: an auto policy under a capacity between a rank's streamed and
    resident estimates streams, logs it and writes the resident stratified
    grid's .Q and .P byte for byte; ``--stream 1`` never makes a tensor of
    the reader's rows or of the rank's block (a spy in every rank).

This module imports neither JAX nor tests.conftest at its top: the ranks
import it to find their functions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.io.stage import gather_thread_share
from neural_admixture_tpu_torch.io.writers import _flatten
from neural_admixture_tpu_torch.parallel import distributed as tdist
from neural_admixture_tpu_torch.train.engine import (
    NeuralAdmixtureTrainer, TrainConfig, block_geometry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_BED = os.path.join(REPO, "demo", "data", "demo_data.bed")
N, M, K, H, D, B, LR, SEED = 100, 6000, 3, 32, 4, 40, 2e-3, 5
KW = dict(epochs=2, batch_size=B, learning_rate=LR, seed=SEED,
          hidden_size=H, n_components=D, ks=[K], progress=False)
MODES = ("one_k", "multihead", "supervised", "split")


def _data(n=N):
    rng = np.random.default_rng(10)
    packed, m_pad = pack_with_padding(
        rng.integers(0, 4, size=(n, M)).astype(np.uint8))
    rng = np.random.default_rng(11)
    V = (rng.normal(size=(D, M)) / np.sqrt(M)).astype(np.float32)
    P_init = rng.uniform(0.05, 0.95, size=(K, M)).astype(np.float32)
    return packed, m_pad, V, P_init


def _launch(grid, packed, V, P_init, n, blk, stream, cfg=None, env=None,
            init=None, plans=None, pops=None):
    """One launch_training of this rank on its data row's rows, under the
    variables ``env``: (Qs, Ps, params, logged losses, the trainer)."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        tr = NeuralAdmixtureTrainer(TrainConfig(
            device="cpu", sample_block=blk, stream=stream,
            **{**KW, **(cfg or {})}), grid=grid)
        start, end, _ = tr.sample_shard(packed.shape[1] * 4, n)
        Qs, Ps, params = tr.launch_training(
            P_init, packed[start:end], V, M, n, init_params=init,
            plans=None if plans is None else (lambda e: plans[e]),
            pops=pops, host_rows=(start, end))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return Qs, Ps, params, tr.logged_losses, tr


def _pair_2x2(grid, packed, V, P_init, init, plans):
    """The resident stratified and the streamed 2 x 2 runs of one rank, and
    the staged infer_q_mesh with the trained parameters against the sharded
    pass over the block uploaded whole."""
    from neural_admixture_tpu_torch.infer import infer_q_mesh
    from neural_admixture_tpu_torch.models.qp import params_from_numpy
    from neural_admixture_tpu_torch.parallel.grid import shard_params
    from neural_admixture_tpu_torch.parallel.sharded_step import (
        infer_q_sharded)
    resident = _launch(grid, packed, V, P_init, N, 16, False,
                       env={"NA_TPU_STRATIFIED": "1"}, init=init,
                       plans=plans)
    streamed = _launch(grid, packed, V, P_init, N, 16, True, init=init,
                       plans=plans)
    params = resident[2]
    start = grid.d * (N // 2)
    staged = infer_q_mesh(params, packed[start:start + N // 2], N, [K], 16,
                          grid)[0]
    w = packed.shape[1] // 2
    block = packed[start:start + N // 2, grid.s * w:(grid.s + 1) * w]
    model = params_from_numpy(shard_params(params, 2, grid.s), [K])
    whole = infer_q_sharded(model, grid, torch.from_numpy(
        np.ascontiguousarray(block)), N // 2, 16)[f"k{K}"]
    return (resident[:4], streamed[:4], streamed[4]._streamed,
            streamed[4].stager.gather_threads, staged, whole)


def _pairs_2x1(grid, packed, V, P_init, n):
    """Per mode, the resident stratified and the streamed 2 x 1 runs of one
    rank with sample_block 1."""
    out = {}
    for mode in MODES:
        cfg, env, P0, pops = None, {}, P_init, None
        if mode == "multihead":
            cfg = {"ks": [2, 3]}
            P0 = np.concatenate([P_init[:2], P_init])
        elif mode == "supervised":
            pops = np.arange(n) % K
        elif mode == "split":
            env = {"NA_TPU_SPLIT_LOSS": "1"}
        resident = _launch(grid, packed, V, P0, n, 1, False, cfg,
                           {**env, "NA_TPU_STRATIFIED": "1"}, pops=pops)
        streamed = _launch(grid, packed, V, P0, n, 1, True, cfg, env,
                           pops=pops)
        out[mode] = (resident[:4], streamed[:4], streamed[4]._streamed)
    return out


def _jax_init_and_stratified_plans(V, P_init, m_pad):
    """The JAX engine's initial parameters and stratified plans on a 2-wide
    data axis with sample_block 16, from its key stream (engine.py:919-920,
    :460-464)."""
    import jax
    from neural_admixture_tpu.models import qp as jqp
    from neural_admixture_tpu.train.engine import _stratified_plan
    key = jax.random.PRNGKey(SEED)
    key, k_init = jax.random.split(key)
    params = jax.tree.map(np.asarray, jqp.init_params(
        k_init, np.asarray(V).T, P_init, H, [K], m_pad=m_pad))
    b_round, nb, b_rem, n_rows = block_geometry(N, B, 16, 2)
    plans = []
    for _ in range(KW["epochs"]):
        key, k_epoch = jax.random.split(key)
        plans.append(tuple(np.asarray(a) for a in _stratified_plan(
            k_epoch, 2, 16, N, n_rows, b_round, nb, b_rem)))
    return params, plans


def _assert_equal(got, want):
    (Qg, Pg, pg, lg), (Qw, Pw, pw, lw) = got, want
    for a, b in zip(Qg + Pg, Qw + Pw):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
    fg, fw = _flatten(pg), _flatten(pw)
    assert fg.keys() == fw.keys()
    for name in fg:
        assert torch.equal(torch.from_numpy(fg[name]),
                           torch.from_numpy(fw[name])), name
    assert lg == lw and lg


@pytest.fixture(scope="module")
def grid_2x2(tmp_path_factory):
    packed, m_pad, V, P_init = _data()
    init, plans = _jax_init_and_stratified_plans(V, P_init, m_pad)
    rdv = tmp_path_factory.mktemp("rdv") / "rdv"
    runs = tdist.spawn_grid(_pair_2x2, 2, 2, args=(
        packed, V, P_init, init, plans), init_method=f"file://{rdv}")
    return packed, V, P_init, runs


def test_streamed_2x2_equals_the_resident_stratified_grid(grid_2x2):
    for resident, streamed, was_streamed, _, _, _ in grid_2x2[3]:
        assert was_streamed
        _assert_equal(streamed, resident)


def test_resident_stratified_2x2_tracks_the_jax_engine(grid_2x2,
                                                      monkeypatch, caplog):
    import logging
    from neural_admixture_tpu.train import engine as jengine
    from tests.conftest import assert_trajectory_close
    packed, V, P_init, runs = grid_2x2
    monkeypatch.setenv("NA_TPU_EMULATE_PROC_SHARDS", "2,2")
    monkeypatch.setenv("NA_TPU_STRATIFIED", "1")
    caplog.set_level(logging.INFO)
    jtr = jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        use_pallas=False, mesh_shape=(2, 2), sample_block=16, **KW))
    Qw, Pw, pw = jtr.launch_training(P_init, packed, V, M, N)
    (loss_j,) = [float(r.getMessage().rsplit(" ", 1)[1].replace(",", ""))
                 for r in caplog.records if "Loss in epoch" in r.getMessage()]
    flat_w = _flatten(jax_tree_to_numpy(pw))
    for resident, *_ in runs:
        Qs, Ps, params, losses = resident
        np.testing.assert_allclose(losses[0], loss_j, rtol=1e-5)
        assert_trajectory_close(Ps[0], Pw[0], LR)
        assert_trajectory_close(Qs[0], Qw[0], LR)
        for name, a in _flatten(params).items():
            assert_trajectory_close(a, flat_w[name], LR)


def jax_tree_to_numpy(tree):
    return {k: (jax_tree_to_numpy(v) if isinstance(v, dict)
                else np.asarray(v)) for k, v in tree.items()}


def test_staged_grid_infer_equals_the_uploaded_block(grid_2x2):
    for *_, staged, whole in grid_2x2[3]:
        assert torch.equal(torch.from_numpy(staged),
                           torch.from_numpy(whole))


def test_grid_ranks_share_the_hosts_cores_for_their_gathers(grid_2x2):
    threads = [r[3] for r in grid_2x2[3]]
    assert threads == [gather_thread_share(4)] * 4
    assert sum(threads) <= max(4, os.cpu_count() or 1)


@pytest.fixture(scope="module")
def grid_2x1(tmp_path_factory):
    """N = 101 gives the remainder batch one padding row."""
    n = N + 1
    packed, _, V, P_init = _data(n)
    rdv = tmp_path_factory.mktemp("rdv") / "rdv"
    return tdist.spawn_grid(_pairs_2x1, 2, 1, args=(packed, V, P_init, n),
                            init_method=f"file://{rdv}")


@pytest.mark.parametrize("mode", MODES)
def test_streamed_2x1_per_row_sampling_equals_resident(grid_2x1, mode):
    for rank in grid_2x1:
        resident, streamed, was_streamed = rank[mode]
        assert was_streamed
        _assert_equal(streamed, resident)


def _cli(out_dir, name, extra=()):
    return [sys.executable, "-m", "neural_admixture_tpu_torch.entry",
            "train", "--k", "2", "--data_path", DEMO_BED, "--save_dir",
            str(out_dir), "--name", name, "--epochs", "4", "--seed", "7",
            "--batch_size", "64", "--hidden_size", "32", "--no_progress",
            "--num_gpus", "0", "--mesh", "2x1", "--sample_block", "1", *extra]


def _run(cmd, env):
    r = subprocess.run(cmd, cwd=REPO, env={**os.environ, **env},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout + r.stderr


def test_grid_auto_policy_streams_and_writes_the_stratified_files(tmp_path):
    """A capacity the resident rows do not fit and the streamed need does:
    the grid streams. Each rank's estimate on the demo (m_pad 10,240, 2,560
    packed bytes a row): its 53 rows 135,680 B, half a batch 81,920 B, the
    SNP plane 10,240 x (8 + 2) x 16 = 1,638,400 B; resident 1,856,000 B
    against a budget of 0.9 x 0.00185 GiB = 1,787,792 B, streamed
    1,720,320 B. Its files are the resident stratified grid's."""
    out = _run(_cli(tmp_path, "auto"), {"NA_TPU_HBM_CAPACITY_GB": "0.00185"})
    assert "Host-streaming (out-of-core) training: packed genotypes " \
        "(0.0 GiB per rank) stay in host memory" in out, out[-3000:]
    ref = _run(_cli(tmp_path, "ref"), {"NA_TPU_STRATIFIED": "1"})
    assert "Host-streaming" not in ref
    for m in ("Q", "P"):
        assert (tmp_path / f"auto.2.{m}").read_bytes() == \
            (tmp_path / f"ref.2.{m}").read_bytes()


def _spied_train_rank(grid, args, stream, n, m, t0):
    """The CLI's rank (train/run.py _train_rank) with a spy on every way a
    host array becomes a tensor: returns the calls that were given a view
    of the reader's rows or of an array a stager streams from."""
    from neural_admixture_tpu_torch.io import stage
    from neural_admixture_tpu_torch.train import run as trun
    watched, made = [], []
    read, batches = trun.read_packed_rows, stage.HostStager.batches

    def spy_read(*a, **kw):
        out = read(*a, **kw)
        watched.append(out)
        return out

    def spy_batches(self, src, jobs):
        watched.append(src)
        return batches(self, src, jobs)

    def spied(fn):
        def wrapper(data, *a, **kw):
            if isinstance(data, np.ndarray) and data.ndim == 2:
                made.append((fn.__name__, data))
            return fn(data, *a, **kw)
        return wrapper

    trun.read_packed_rows = spy_read
    stage.HostStager.batches = spy_batches
    for name in ("from_numpy", "as_tensor", "tensor"):
        setattr(torch, name, spied(getattr(torch, name)))
    trun._train_rank(grid, args, stream, n, m, t0)
    return [name for name, a in made
            if any(np.may_share_memory(a, w) for w in watched)]


@pytest.mark.parametrize("stream,uploads", [("1", False), ("0", True)])
def test_cli_stream_on_a_grid_never_uploads_the_packed_rows(tmp_path, stream,
                                                           uploads):
    """Every rank of ``--stream 1 --mesh 2x1`` runs the RSVD, the init,
    training, the Q pass and the log-likelihood without a tensor of its
    rows; ``--stream 0`` makes one (the set-up's upload)."""
    from neural_admixture_tpu_torch.entry import parse_train_args
    from neural_admixture_tpu_torch.infer import input_dims
    from neural_admixture_tpu_torch.train.run import STREAM_MAP
    args = parse_train_args(_cli(tmp_path, "s", ("--stream", stream))[4:])
    n, m = input_dims(DEMO_BED)
    seen = tdist.spawn_grid(_spied_train_rank, 2, 1, args=(
        args, STREAM_MAP[stream], n, m, 0.0),
        init_method=f"file://{tmp_path}/rdv")
    for rank in seen:
        assert bool(rank) == uploads, rank
    assert (tmp_path / "s.2.Q").exists()
