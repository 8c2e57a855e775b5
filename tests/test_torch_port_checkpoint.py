"""Checkpoint/resume and SIGTERM preemption in the port, on the CPU.

The counterparts of tests/test_checkpoint_resume.py:24, :45, :54,
tests/test_preempt.py:28 and tests/test_stream.py:164:

  * a run stopped at a checkpoint and resumed equals the uninterrupted run
    exactly (Q, P and every parameter ``torch.equal``), resident, streamed,
    and across the two (a streamed run resumes a resident run's checkpoint
    and the reverse: ``stream`` is not in the meta);
  * ``resume`` without a file starts fresh;
  * each hyperparameter of the meta, changed, is refused with the JAX
    package's message (the meta also records the grid's shape, which is not
    refused); a file of the JAX package's layout is refused;
  * the file's layout: ``format``, ``epoch``, ``meta``, ``param/*`` and
    Adam's ``exp_avg``, ``exp_avg_sq`` and ``step`` as plain arrays;
  * the SIGTERM handler is on only with checkpoints, restored afterwards,
    and off the main thread does nothing;
  * the real CLI as a subprocess on ``--num_gpus 0``: SIGTERM exits 143
    with the log line, ``--resume`` finishes from the saved epoch.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.io.writers import _flatten
from neural_admixture_tpu_torch.train.engine import (
    CKPT_FORMAT, NeuralAdmixtureTrainer, TrainConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, K = 48, 500, 3


def _data(seed=0, d=4, k=K):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    V = (rng.normal(size=(d, M)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(k, M)).astype(np.float32)
    return pack_with_padding(G)[0], V, P0


def _cfg(path, epochs, **kw):
    base = dict(epochs=epochs, batch_size=16, learning_rate=5e-3, seed=0,
                hidden_size=32, n_components=4, ks=[K], progress=False,
                sample_block=8, device="cpu", stream=False,
                checkpoint_path=str(path))
    base.update(kw)
    return TrainConfig(**base)


def _run(cfg, pops=None, data=None):
    packed, V, P0 = data or _data(d=cfg.n_components, k=sum(cfg.ks))
    tr = NeuralAdmixtureTrainer(cfg)
    return tr.launch_training(P0, packed, V, M, N, pops=pops), tr


def _assert_equal(a, b):
    (Qa, Pa, pa), (Qb, Pb, pb) = a, b
    for x, y in zip(Qa + Pa, Qb + Pb):
        assert torch.equal(torch.from_numpy(x), torch.from_numpy(y))
    fa, fb = _flatten(pa), _flatten(pb)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert torch.equal(torch.from_numpy(fa[name]),
                           torch.from_numpy(fb[name])), name


@pytest.mark.parametrize("first,second", [
    (False, False), (True, True), (False, True), (True, False)])
@pytest.mark.parametrize("blk", [1, 8])
def test_resume_equals_uninterrupted(tmp_path, caplog, blk, first, second):
    """Epochs 0-2 with checkpoints every 3 (first leg streamed or not),
    then resumed to 6 (streamed or not), against 6 epochs in one run."""
    full, _ = _run(_cfg(tmp_path / "a.npz", 6, sample_block=blk))
    _run(_cfg(tmp_path / "b.npz", 3, sample_block=blk, checkpoint_every=3,
              stream=first))
    with np.load(tmp_path / "b.npz") as f:
        assert int(f["epoch"]) == 3
    caplog.set_level("INFO")
    resumed, tr = _run(_cfg(tmp_path / "b.npz", 6, sample_block=blk,
                            checkpoint_every=3, resume=True, stream=second))
    _assert_equal(resumed, full)
    lines = [r.getMessage() for r in caplog.records]
    assert "    Resuming from epoch 3." in lines
    # The throughput line counts only the epochs run.
    assert any(ln.startswith("    Training throughput:")
               and ln.endswith("for 3 epochs).") for ln in lines)
    assert len(tr.epoch_seconds) == 3 and "load" in tr.phase_seconds


def test_supervised_resume_equals_uninterrupted(tmp_path):
    pops = np.random.default_rng(4).integers(0, K, size=N)
    full, _ = _run(_cfg(tmp_path / "a.npz", 4), pops=pops)
    _run(_cfg(tmp_path / "b.npz", 2, checkpoint_every=1), pops=pops)
    resumed, _ = _run(_cfg(tmp_path / "b.npz", 4, checkpoint_every=1,
                           resume=True), pops=pops)
    _assert_equal(resumed, full)


def test_resume_without_checkpoint_starts_fresh(tmp_path, caplog):
    caplog.set_level("INFO")
    fresh, _ = _run(_cfg(tmp_path / "none.npz", 2))
    resumed, tr = _run(_cfg(tmp_path / "none.npz", 2, resume=True))
    _assert_equal(resumed, fresh)
    assert not any("Resuming" in r.getMessage() for r in caplog.records)
    assert "load" not in tr.phase_seconds
    assert not (tmp_path / "none.npz").exists()  # checkpoint_every is 0


CHANGES = {"ks": {"ks": [4]}, "batch_size": {"batch_size": 24},
           "hidden_size": {"hidden_size": 64},
           "n_components": {"n_components": 5}, "seed": {"seed": 7},
           "sample_block": {"sample_block": 4},
           "learning_rate": {"learning_rate": 1e-3},
           "supervised": {}, "supervised_loss_weight":
               {"supervised_loss_weight": 5.0}}


@pytest.mark.parametrize("key", list(CHANGES))
def test_resume_refuses_each_changed_hyperparameter(tmp_path, key):
    ck = tmp_path / "ck.npz"
    _run(_cfg(ck, 2, checkpoint_every=2))
    saved = json.loads(bytes(np.load(ck)["meta"]).decode())
    # The grid's shape is recorded, [1, 1] on one device, and never
    # refused: a resume may change it (test_torch_port_grid_checkpoint.py).
    assert key in saved and saved["mesh_shape"] == [1, 1]
    cfg = _cfg(ck, 4, checkpoint_every=2, resume=True, **CHANGES[key])
    pops = (np.random.default_rng(1).integers(0, K, size=N)
            if key == "supervised" else None)
    with pytest.raises(ValueError, match="Checkpoint hyperparameters do not "
                       "match this run; refusing to resume. Mismatches "
                       rf"\(checkpoint vs now\): {key}: "):
        _run(cfg, pops=pops)


def test_resume_refuses_a_jax_checkpoint(tmp_path):
    """The JAX package's leaf_i layout is refused with a clear ValueError,
    not a KeyError."""
    from neural_admixture_tpu.train import engine as jengine
    ck = tmp_path / "jax_ckpt.npz"
    packed, V, P0 = _data()
    jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        epochs=1, batch_size=16, learning_rate=5e-3, seed=0, hidden_size=32,
        n_components=4, ks=[K], progress=False, use_pallas=False,
        mesh_shape=(1, 1), checkpoint_every=1,
        checkpoint_path=str(ck))).launch_training(P0, packed, V, M, N)
    assert "leaf_0" in np.load(ck).files
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        _run(_cfg(ck, 2, checkpoint_every=1, resume=True))


def test_checkpoint_layout(tmp_path):
    ck = tmp_path / "ck.npz"
    (_, _, params), tr = _run(_cfg(ck, 2, checkpoint_every=2))
    with np.load(ck) as f:
        files = set(f.files)
        assert bytes(f["format"]).decode() == CKPT_FORMAT
        assert int(f["epoch"]) == 2
        flat = _flatten(params)
        for name, a in flat.items():
            np.testing.assert_array_equal(f[f"param/{name}"], a)
            assert f[f"adam/{name}/exp_avg"].shape == a.shape
            assert f[f"adam/{name}/exp_avg_sq"].dtype == np.float32
            # 2 epochs of 3 steps (16, 16 and the 16-row remainder).
            assert int(f[f"adam/{name}/step"]) == 6
    assert files == ({"format", "epoch", "meta"}
                     | {f"param/{n}" for n in flat}
                     | {f"adam/{n}/{s}" for n in flat
                        for s in ("exp_avg", "exp_avg_sq", "step")})
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    assert tr.phase_seconds["save"] > 0


def test_sigterm_handler_only_with_checkpoints_and_restored(tmp_path):
    seen = []

    class Probe(NeuralAdmixtureTrainer):
        def _save_checkpoint(self, epoch, model, opt):
            seen.append(signal.getsignal(signal.SIGTERM))
            super()._save_checkpoint(epoch, model, opt)

    before = signal.getsignal(signal.SIGTERM)
    packed, V, P0 = _data()
    Probe(_cfg(tmp_path / "c.npz", 2, checkpoint_every=1)).launch_training(
        P0, packed, V, M, N)
    assert len(seen) == 2 and seen[0] is not before
    assert signal.getsignal(signal.SIGTERM) is before
    # Off the main thread the handler cannot be installed; training runs.
    errors = []

    def train():
        try:
            _run(_cfg(tmp_path / "t.npz", 2, checkpoint_every=1))
        except BaseException as exc:  # reported below
            errors.append(exc)
    t = threading.Thread(target=train)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors
    assert (tmp_path / "t.npz").exists()


def _cli(out, epochs, resume=False):
    cmd = [sys.executable, "-u", "-m", "neural_admixture_tpu_torch.entry",
           "train", "--k", "2", "--data_path",
           os.path.join(REPO, "demo", "data", "demo_data.bed"), "--save_dir",
           str(out), "--name", "pre", "--epochs", str(epochs), "--seed", "3",
           "--batch_size", "64", "--hidden_size", "32", "--no_progress",
           "--checkpoint_every", "5", "--num_gpus", "0"]
    return cmd + ["--resume"] if resume else cmd


def test_cli_sigterm_checkpoints_and_resumes(tmp_path):
    """As tests/test_preempt.py for the JAX package: wait for the first
    periodic checkpoint (epoch 5), send SIGTERM, expect rc 143 and the log
    line, then --resume to the end. 60 epochs of the demo at hidden size 32
    leave seconds between the first checkpoint and the last epoch."""
    epochs = 60
    env = dict(os.environ, PYTHONPATH=REPO)
    ckpt = tmp_path / "pre_ckpt.npz"
    p = subprocess.Popen(_cli(tmp_path, epochs), cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        deadline = time.time() + 120
        while not ckpt.exists() and time.time() < deadline:
            assert p.poll() is None, p.communicate()[0][-3000:]
            time.sleep(0.05)
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
    assert 5 <= stopped_at < epochs
    assert not (tmp_path / "pre.2.Q").exists()
    r = subprocess.run(_cli(tmp_path, epochs, resume=True), cwd=REPO,
                       env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=180)
    assert r.returncode == 0, r.stdout[-3000:]
    assert f"    Resuming from epoch {stopped_at}." in r.stdout
    assert f"for {epochs - stopped_at} epochs)." in r.stdout
    Q = np.loadtxt(tmp_path / "pre.2.Q")
    assert Q.shape == (105, 2)
    np.testing.assert_allclose(Q.sum(axis=1), 1.0, rtol=1e-4)
