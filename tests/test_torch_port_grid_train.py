"""Training and inference over a grid of CPU ranks, against the JAX engine
and the port's one-rank runs.

  * launch_training on a 2 x 2 grid with sample_block 16, from the JAX
    package's initial parameters and plans, against the JAX engine's
    single-process run emulating two processes on a (2, 2) mesh
    (NA_TPU_EMULATE_PROC_SHARDS=2,2), and against the port's one-rank run
    under the same emulation; a 2 x 1 grid with sample_block 1 against the
    port's plain one-rank run (as tests/test_multihost.py:113-134 holds the
    JAX package's two processes to one): the Adam-aware trajectory rule of
    tests/conftest.py;
  * the CLI: ``train --num_gpus 0 --mesh 2x1`` on the demo BED and
    ``--mesh 2x2`` on a synthetic BED (M % 8 == 0) against the one-rank
    CLI runs (rtol 1e-4, atol 1e-5), rank 0 alone writing and every rank
    naming its rows; two hosts of two ranks each through the NA_TPU_*
    variables; ``infer --num_gpus 0 --mesh 2x1`` (rtol 2e-5, atol 2e-6);
  * no fallback: a --mesh larger than the visible cards, and --num_gpus
    above them (the clamp). Streaming and checkpoints on a grid:
    tests/test_torch_port_grid_stream.py, test_torch_port_grid_checkpoint.py.

This module imports neither JAX nor tests.conftest at its top: the ranks
import it to find their function.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.parallel import distributed as tdist
from neural_admixture_tpu_torch.train.engine import (
    NeuralAdmixtureTrainer, TrainConfig, block_geometry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_BED = os.path.join(REPO, "demo", "data", "demo_data.bed")
N, M, K, H, D, B, LR, SEED = 100, 6000, 3, 32, 4, 40, 2e-3, 5
KW = dict(epochs=2, batch_size=B, learning_rate=LR, seed=SEED,
          hidden_size=H, n_components=D, ks=[K], progress=False)
# The CLI runs of tests/test_multihost.py.
CLI_EPOCHS, CLI_K, CLI_BATCH, CLI_HIDDEN, CLI_SEED = 6, 2, 64, 32, 7


def _data(n=N):
    rng = np.random.default_rng(10)
    packed, m_pad = pack_with_padding(
        rng.integers(0, 4, size=(n, M)).astype(np.uint8))
    rng = np.random.default_rng(11)
    V = (rng.normal(size=(D, M)) / np.sqrt(M)).astype(np.float32)
    P_init = rng.uniform(0.05, 0.95, size=(K, M)).astype(np.float32)
    return packed, m_pad, V, P_init


def _train_rank(grid, packed, V, P_init, n, blk, init=None, plans=None,
                cfg=None, pops=None):
    """One rank's launch_training on its data row's rows."""
    tr = NeuralAdmixtureTrainer(TrainConfig(device="cpu", sample_block=blk,
                                            **{**KW, **(cfg or {})}),
                                grid=grid)
    start, end, _ = tr.sample_shard(packed.shape[1] * 4, n)
    Qs, Ps, params = tr.launch_training(
        P_init, packed[start:end], V, M, n, init_params=init,
        plans=None if plans is None else (lambda e: plans[e]), pops=pops,
        host_rows=(start, end))
    return Qs, Ps, params, tr.logged_losses


def _jax_init_and_plans(V, P_init, m_pad, blk, d_sz):
    """The JAX engine's initial parameters and plans on a d_sz-wide data
    axis, from its key stream (engine.py:919-920, :465-478, :1395)."""
    import jax
    from neural_admixture_tpu.models import qp as jqp
    key = jax.random.PRNGKey(SEED)
    key, k_init = jax.random.split(key)
    params = jax.tree.map(np.asarray, jqp.init_params(
        k_init, np.asarray(V).T, P_init, H, [K], m_pad=m_pad))
    b_round, nb, _, n_rows = block_geometry(N, B, blk, d_sz)
    F = b_round // blk
    plans = []
    for _ in range(KW["epochs"]):
        key, k_epoch = jax.random.split(key)
        perm = np.asarray(jax.random.permutation(k_epoch, N // blk))
        plans.append((perm[:(nb - 1) * F].reshape(nb - 1, F),
                      np.concatenate([perm[(nb - 1) * F:],
                                      np.arange(N // blk, n_rows // blk)])))
    return params, plans


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_runs_close(got, want):
    from tests.conftest import assert_trajectory_close
    (Qg, Pg, pg), (Qw, Pw, pw) = got[:3], want[:3]
    for q, p, q_want, p_want in zip(Qg, Pg, Qw, Pw):
        assert_trajectory_close(p, p_want, LR)
        assert_trajectory_close(q, q_want, LR)
    flat_w = _flat(pw)
    for name, a in _flat(pg).items():
        assert_trajectory_close(a, flat_w[name], LR)


@pytest.fixture(scope="module")
def grid_2x2(tmp_path_factory):
    """The 2 x 2 grid's run from the JAX package's init and plans."""
    packed, m_pad, V, P_init = _data()
    init, plans = _jax_init_and_plans(V, P_init, m_pad, 16, 2)
    rdv = tmp_path_factory.mktemp("rdv") / "rdv"
    runs = tdist.spawn_grid(_train_rank, 2, 2, args=(
        packed, V, P_init, N, 16, init, plans), init_method=f"file://{rdv}")
    return packed, V, P_init, init, plans, runs


def test_grid_2x2_tracks_the_jax_engine_emulating_two_processes(
        grid_2x2, monkeypatch, caplog):
    from neural_admixture_tpu.train import engine as jengine
    packed, V, P_init, _, _, runs = grid_2x2
    monkeypatch.setenv("NA_TPU_EMULATE_PROC_SHARDS", "2,2")
    caplog.set_level(logging.INFO)
    jtr = jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        use_pallas=False, mesh_shape=(2, 2), sample_block=16, **KW))
    want = jtr.launch_training(P_init, packed, V, M, N)
    (loss_j,) = [float(r.getMessage().rsplit(" ", 1)[1].replace(",", ""))
                 for r in caplog.records if "Loss in epoch" in r.getMessage()]
    for run in runs:  # every rank returns the whole results
        np.testing.assert_allclose(run[3][0], loss_j, rtol=1e-5)
        _assert_runs_close(run, want)


def test_grid_2x2_tracks_the_one_rank_run_under_the_emulation(
        grid_2x2, monkeypatch):
    packed, V, P_init, init, plans, runs = grid_2x2
    monkeypatch.setenv("NA_TPU_EMULATE_PROC_SHARDS", "2,2")
    tr = NeuralAdmixtureTrainer(TrainConfig(device="cpu", sample_block=16,
                                            **KW))
    want = tr.launch_training(P_init, packed, V, M, N, init_params=init,
                              plans=lambda e: plans[e])
    np.testing.assert_allclose(runs[0][3][0], tr.logged_losses[0],
                               rtol=1e-5)
    _assert_runs_close(runs[0], want)


@pytest.mark.parametrize("mode", ["unsupervised", "multihead",
                                  "supervised"])
def test_grid_2x1_per_row_sampling_tracks_the_plain_one_rank_run(tmp_path,
                                                                 mode):
    """sample_block 1 draws the same plans on any data axis; N = 101 gives
    the grid's remainder batch one padding row. Multi-head: K = 2 and 3 at
    once; supervised: labels of K = 3 classes, the CE on the smallest
    head."""
    n = N + 1
    packed, _, V, P_init = _data(n)
    cfg, pops = None, None
    if mode == "multihead":
        cfg = {"ks": [2, 3]}
        P_init = np.concatenate([P_init[:2], P_init])
    elif mode == "supervised":
        pops = np.arange(n) % K
    runs = tdist.spawn_grid(_train_rank, 2, 1,
                            args=(packed, V, P_init, n, 1, None, None, cfg,
                                  pops),
                            init_method=f"file://{tmp_path}/rdv")
    tr = NeuralAdmixtureTrainer(TrainConfig(device="cpu", sample_block=1,
                                            **{**KW, **(cfg or {})}))
    want = tr.launch_training(P_init, packed, V, M, n, pops=pops)
    np.testing.assert_allclose(runs[0][3][0], tr.logged_losses[0],
                               rtol=1e-5)
    _assert_runs_close(runs[0], want)
    _assert_runs_close(runs[1], want)


def _cli(out_dir, name, data=DEMO_BED, sample_block=1, extra=()):
    return ["train", "--k", str(CLI_K), "--data_path", str(data),
            "--save_dir", str(out_dir), "--name", name, "--epochs",
            str(CLI_EPOCHS), "--seed", str(CLI_SEED), "--batch_size",
            str(CLI_BATCH), "--hidden_size", str(CLI_HIDDEN), "--no_progress",
            "--sample_block", str(sample_block), "--num_gpus", "0", *extra]


def _run_cli(argv, env=None, timeout=300):
    r = subprocess.run([sys.executable, "-m",
                        "neural_admixture_tpu_torch.entry", *argv],
                       cwd=REPO, env={**os.environ, **(env or {})},
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout + r.stderr


def _assert_outputs_close(dir_a, name_a, dir_b, name_b, k=CLI_K):
    for m in ("Q", "P"):
        np.testing.assert_allclose(np.loadtxt(dir_a / f"{name_a}.{k}.{m}"),
                                   np.loadtxt(dir_b / f"{name_b}.{k}.{m}"),
                                   rtol=1e-4, atol=1e-5, err_msg=m)


def test_cli_train_2x1_on_the_demo_matches_one_rank(tmp_path):
    out = _run_cli(_cli(tmp_path, "mh", extra=("--mesh", "2x1")))
    assert "this one holds rows [0, 53)" in out, out[-3000:]
    assert "this one holds rows [53, 105)" in out, out[-3000:]
    # Rank 0 alone logs the results and writes the files.
    assert out.count("Q and P matrices written for K = 2.") == 1
    assert out.count("Log-likelihood:") == 1
    assert tentry.main(_cli(tmp_path, "sp")) == 0
    assert sorted(p.name for p in tmp_path.glob("mh*")) == [
        "mh.2.P", "mh.2.Q", "mh.npz", "mh.pt", "mh_config.json"]
    _assert_outputs_close(tmp_path, "mh", tmp_path, "sp")


def _write_synthetic_bed(path, n=120, m=256, seed=11):
    """tests/test_multihost.py's synthetic BED: M % 8 == 0, missing codes
    in the first rows only (data row 0 has them, data row 1 not)."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, size=(n, m)).astype(np.uint8)
    G[:4, ::17] = 3
    code_of = np.array([3, 2, 0, 1], dtype=np.uint8)
    Bm = np.zeros((m, (n + 3) // 4), dtype=np.uint8)
    for i in range(n):
        Bm[:, i // 4] |= code_of[G[i]] << np.uint8(2 * (i % 4))
    with open(path, "wb") as f:
        f.write(b"\x6c\x1b\x01" + Bm.tobytes())
    stem = str(path)[:-4]
    with open(stem + ".fam", "w") as f:
        f.writelines(f"f{i} i{i} 0 0 0 -9\n" for i in range(n))
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1 snp{j} 0 {j} A C\n" for j in range(m))


@pytest.fixture(scope="module")
def synthetic_2x2(tmp_path_factory):
    """The 2 x 2 grid CLI on a synthetic BED with block sampling, and the
    one-rank CLI emulating its layout."""
    d = tmp_path_factory.mktemp("syn")
    bed = d / "syn.bed"
    _write_synthetic_bed(bed)
    grid_out = _run_cli(_cli(d, "grid", bed, 16, ("--mesh", "2x2")))
    _run_cli(_cli(d, "emul", bed, 16),
             env={"NA_TPU_EMULATE_PROC_SHARDS": "2,2"})
    return d, bed, grid_out


def test_cli_train_2x2_block_sampling_matches_the_emulated_one_rank(
        synthetic_2x2):
    d, _, out = synthetic_2x2
    for rows in ("[0, 64)", "[64, 120)"):
        assert out.count(f"this one holds rows {rows}") == 2, out[-3000:]
    assert out.count("Q and P matrices written for K = 2.") == 1
    _assert_outputs_close(d, "grid", d, "emul")


def test_cli_two_hosts_of_two_ranks_match_one_host(synthetic_2x2):
    """Two hosts through NA_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID, each
    starting the two ranks of one data row: the one-host grid's files."""
    d, bed, _ = synthetic_2x2
    env = {"NA_TPU_COORDINATOR": f"127.0.0.1:{tdist.free_port()}",
           "NA_TPU_NUM_PROCESSES": "2"}
    cmd = [sys.executable, "-m", "neural_admixture_tpu_torch.entry",
           *_cli(d, "hosts", bed, 16, ("--mesh", "2x2"))]
    procs = [subprocess.Popen(cmd, cwd=REPO, text=True,
                              env={**os.environ, **env,
                                   "NA_TPU_PROCESS_ID": str(h)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for h in (1, 0)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "this one holds rows [64, 120)" in outs[0], outs[0][-3000:]
    assert "this one holds rows [0, 64)" in outs[1], outs[1][-3000:]
    assert "Q and P matrices written" not in outs[0]
    _assert_outputs_close(d, "hosts", d, "grid")


def test_cli_infer_2x1_matches_one_rank(tmp_path):
    assert tentry.main(_cli(tmp_path, "m", extra=("--epochs", "2"))) == 0
    argv = ["infer", "--name", "m", "--save_dir", str(tmp_path),
            "--data_path", DEMO_BED, "--num_gpus", "0", "--out_name"]
    assert tentry.main(argv + ["one"]) == 0
    assert tentry.main(argv + ["grid", "--mesh", "2x1"]) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "grid.2.Q"),
                               np.loadtxt(tmp_path / "one.2.Q"),
                               rtol=2e-5, atol=2e-6)


def test_mesh_larger_than_the_cards_raises_the_jax_message(monkeypatch,
                                                          tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 2\) needs 4 "
                       "devices but only 1 are available"):
        tentry.main(["train", "--k", "2", "--data_path", DEMO_BED,
                     "--save_dir", str(tmp_path), "--name", "m",
                     "--num_gpus", "1", "--mesh", "2x2"])


def test_num_gpus_above_the_cards_clamps(monkeypatch, caplog, tmp_path):
    """The JAX package's clamp (entry.py:341-348): --num_gpus 2 with one
    card warns and runs on one device (here: which then finds no CUDA)."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    caplog.set_level(logging.WARNING)
    with pytest.raises(RuntimeError, match="--num_gpus 1 asks for a CUDA"):
        tentry.main(["train", "--k", "2", "--data_path", DEMO_BED,
                     "--save_dir", str(tmp_path), "--name", "m",
                     "--num_gpus", "2"])
    assert ("Requested 2 devices, but only 1 are available. Using 1 "
            "devices.") in caplog.text
