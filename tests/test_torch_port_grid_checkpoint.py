"""Checkpoints, resume and SIGTERM on a grid of CPU ranks.

  * on a 2 x 2 grid (sample_block 16, the stratified plan): a run stopped
    at a checkpoint and resumed equals the uninterrupted one bit for bit,
    resident, streamed, and a streamed run resumed from a resident run's
    file;
  * the file: the one-device layout at full width, with the grid's shape in
    its meta; a changed hyperparameter is refused on every rank with the
    one-device message, and ranks that do not see one file all refuse,
    none hangs (each rank goes on to its next run);
  * across shapes (sample_block 1, sizes where the grid's batches are one
    rank's): a one-device file resumed on a 2 x 2 grid and a 2 x 2 file
    resumed on one device, each against the uninterrupted one-device run
    (rtol 1e-4, atol 1e-5, as tests/test_checkpoint_resume.py:96-97 holds
    the JAX package's);
  * the CLI ``--num_gpus 0 --mesh 2x1 --checkpoint_every 2``: SIGTERM to the
    parent process exits 143 after a save, ``--resume`` exits 0 and writes
    the uninterrupted grid's .Q and .P byte for byte.

This module imports neither JAX nor tests.conftest at its top: the ranks
import it to find their functions.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.io.writers import _flatten
from neural_admixture_tpu_torch.parallel import distributed as tdist
from neural_admixture_tpu_torch.train.engine import (
    CKPT_FORMAT, NeuralAdmixtureTrainer, TrainConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_BED = os.path.join(REPO, "demo", "data", "demo_data.bed")
N, M, K, H, D, B, LR, SEED = 100, 6000, 3, 32, 4, 40, 2e-3, 5
KW = dict(batch_size=B, learning_rate=LR, seed=SEED, hidden_size=H,
          n_components=D, ks=[K], progress=False, device="cpu")


def _data():
    rng = np.random.default_rng(20)
    packed = pack_with_padding(
        rng.integers(0, 4, size=(N, M)).astype(np.uint8))[0]
    V = (rng.normal(size=(D, M)) / np.sqrt(M)).astype(np.float32)
    P_init = rng.uniform(0.05, 0.95, size=(K, M)).astype(np.float32)
    return packed, V, P_init


def _run(grid, data, epochs, blk, path, stream=False, **kw):
    """One launch_training (of this rank, or on one device without a grid):
    (Qs, Ps, params, logged losses)."""
    packed, V, P_init = data
    tr = NeuralAdmixtureTrainer(TrainConfig(
        epochs=epochs, sample_block=blk, stream=stream,
        checkpoint_path=str(path), **{**KW, **kw}), grid=grid)
    start, end = 0, N
    if grid is not None:
        start, end, _ = tr.sample_shard(packed.shape[1] * 4, N)
    out = tr.launch_training(P_init, packed[start:end], V, M, N,
                             host_rows=(start, end) if grid else None)
    return (*out, tr.logged_losses)


def _refusal(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def _grid_cases(grid, data, d):
    """Every 2 x 2 case of one rank: same-grid resumes under the
    stratified plan, the refusals, the resumes across shapes."""
    os.environ["NA_TPU_STRATIFIED"] = "1"
    out = {"full": _run(grid, data, 4, 16, f"{d}/none.npz")}
    out["first_resident"] = _run(grid, data, 2, 16, f"{d}/a.npz",
                                 checkpoint_every=2)
    _run(grid, data, 2, 16, f"{d}/b.npz", stream=True, checkpoint_every=2)
    for name, path, stream in (("resident", "a", False),
                               ("streamed", "b", True),
                               ("resident_to_streamed", "a", True)):
        out[name] = _run(grid, data, 4, 16, f"{d}/{path}.npz", stream=stream,
                         resume=True)
    out["refused_lr"] = _refusal(lambda: _run(
        grid, data, 4, 16, f"{d}/a.npz", resume=True, learning_rate=1e-3))
    out["refused_split"] = _refusal(lambda: _run(
        grid, data, 4, 16, f"{d}/a.npz" if grid.rank else f"{d}/none.npz",
        resume=True))
    del os.environ["NA_TPU_STRATIFIED"]
    out["from_one_device"] = _run(grid, data, 4, 1, f"{d}/one.npz",
                                  resume=True)
    _run(grid, data, 2, 1, f"{d}/grid.npz", checkpoint_every=2)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    data = _data()
    full_one = _run(None, data, 4, 1, d / "none.npz")
    _run(None, data, 2, 1, d / "one.npz", checkpoint_every=2)
    ranks = tdist.spawn_grid(_grid_cases, 2, 2, args=(data, str(d)),
                             init_method=f"file://{d}/rdv")
    return d, data, full_one, ranks


def _assert_equal(got, want):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
    fg, fw = _flatten(got[2]), _flatten(want[2])
    assert fg.keys() == fw.keys()
    for name in fg:
        assert torch.equal(torch.from_numpy(fg[name]),
                           torch.from_numpy(fw[name])), name


@pytest.mark.parametrize("case", ["resident", "streamed",
                                  "resident_to_streamed"])
def test_resumed_grid_equals_the_uninterrupted_grid(runs, case):
    for rank in runs[3]:
        _assert_equal(rank[case], rank["full"])


def test_grid_checkpoint_has_the_one_device_layout_at_full_width(runs):
    d, data, _, ranks = runs
    params = ranks[0]["first_resident"][2]
    flat = _flatten(params)
    assert flat["V"].shape == (data[0].shape[1] * 4, D)
    with np.load(d / "a.npz") as f:
        assert bytes(f["format"]).decode() == CKPT_FORMAT
        assert int(f["epoch"]) == 2
        meta = json.loads(bytes(f["meta"]).decode())
        assert meta["mesh_shape"] == [2, 2]
        assert set(f.files) == ({"format", "epoch", "meta"}
                                | {f"param/{n}" for n in flat}
                                | {f"adam/{n}/{s}" for n in flat
                                   for s in ("exp_avg", "exp_avg_sq",
                                             "step")})
        for name, a in flat.items():
            np.testing.assert_array_equal(f[f"param/{name}"], a)
            assert f[f"adam/{name}/exp_avg"].shape == a.shape
            # 2 epochs of 2 steps: 64 rows (whole blocks of the data
            # axis) and the 64-row remainder.
            assert int(f[f"adam/{name}/step"]) == 4
    assert not (d / "a.npz.tmp.npz").exists()


def test_grid_refuses_a_changed_hyperparameter_on_every_rank(runs):
    for rank in runs[3]:
        assert rank["refused_lr"].startswith(
            "ValueError: Checkpoint hyperparameters do not match this run; "
            "refusing to resume. Mismatches (checkpoint vs now): "
            "learning_rate: 0.002 vs 0.001")


def test_ranks_that_do_not_see_one_checkpoint_all_refuse(runs):
    for rank in runs[3]:
        assert rank["refused_split"].startswith(
            "RuntimeError: the ranks do not see one checkpoint"), \
            rank["refused_split"]


def _assert_close(got, want):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    fw = _flatten(want[2])
    for name, a in _flatten(got[2]).items():
        np.testing.assert_allclose(a, fw[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_one_device_checkpoint_resumes_on_a_2x2_grid(runs):
    for rank in runs[3]:
        _assert_close(rank["from_one_device"], runs[2])


def test_2x2_checkpoint_resumes_on_one_device(runs, caplog):
    d, data, full_one, _ = runs
    caplog.set_level("INFO")
    resumed = _run(None, data, 4, 1, d / "grid.npz", resume=True)
    _assert_close(resumed, full_one)
    lines = [r.getMessage() for r in caplog.records]
    assert "    Checkpoint was trained on mesh (2, 2); resharding onto " \
        "(1, 1) on resume." in lines
    assert "    Resuming from epoch 2." in lines


def _cli(out, name, epochs, *extra):
    return [sys.executable, "-u", "-m", "neural_admixture_tpu_torch.entry",
            "train", "--k", "2", "--data_path", DEMO_BED, "--save_dir",
            str(out), "--name", name, "--epochs", str(epochs), "--seed", "3",
            "--batch_size", "64", "--hidden_size", "32", "--no_progress",
            "--num_gpus", "0", "--mesh", "2x1", *extra]


def test_cli_grid_sigterm_checkpoints_and_resumes(tmp_path):
    """SIGTERM to the ``train`` process (not its ranks) after the first
    periodic checkpoint: every rank saves at one epoch and the command
    exits 143; ``--resume`` finishes with the uninterrupted run's files.
    An epoch of the demo takes about 80 ms on two CPU ranks, so 60 leave
    seconds between the first checkpoint and the last epoch."""
    epochs = 60
    env = dict(os.environ, PYTHONPATH=REPO)
    ckpt = tmp_path / "pre_ckpt.npz"
    p = subprocess.Popen(_cli(tmp_path, "pre", epochs, "--checkpoint_every",
                              "2"), cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        deadline = time.time() + 120
        while not ckpt.exists() and time.time() < deadline:
            assert p.poll() is None, p.communicate()[0][-3000:]
            time.sleep(0.02)
        assert ckpt.exists(), "no periodic checkpoint within 120 s"
        p.send_signal(signal.SIGTERM)
        out = p.communicate(timeout=120)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 143, f"exit {p.returncode}:\n{out[-3000:]}"
    assert "    SIGTERM received: resumable checkpoint saved at epoch" in out
    with np.load(ckpt) as f:
        stopped_at = int(f["epoch"])
        assert json.loads(bytes(f["meta"]).decode())["mesh_shape"] == [2, 1]
    assert 2 <= stopped_at < epochs
    assert not (tmp_path / "pre.2.Q").exists()
    r = subprocess.run(_cli(tmp_path, "pre", epochs, "--checkpoint_every",
                            "2", "--resume"), cwd=REPO, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:]
    assert f"    Resuming from epoch {stopped_at}." in r.stdout
    r = subprocess.run(_cli(tmp_path, "full", epochs), cwd=REPO, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:]
    for m in ("Q", "P"):
        assert (tmp_path / f"pre.2.{m}").read_bytes() == \
            (tmp_path / f"full.2.{m}").read_bytes(), m
