"""Projective inference of the PyTorch port against the JAX package: the
encoder, ``infer_q`` and the ``infer`` CLI (``.npz`` and reference ``.pt``
checkpoints, one K, a K range and a scattered K list) must give the same Q
on the same inputs (rtol 2e-5, atol 2e-6: fp32 in another summation order).
Also: the port imports neither JAX nor the JAX package, and it never falls
back to the CPU when asked for the card."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_admixture_tpu import entry as jentry
from neural_admixture_tpu.infer import infer_q as jinfer_q
from neural_admixture_tpu.io.bed import read_bed_dims
from neural_admixture_tpu.io.packed import pack_with_padding
from neural_admixture_tpu.io.torch_interop import (
    save_pt_checkpoint, torch_state_dict_from_params)
from neural_admixture_tpu.io.writers import save_checkpoint, save_config
from neural_admixture_tpu.models import qp as jqp
from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.infer import infer_q
from neural_admixture_tpu_torch.models.qp import QPEncoder, params_from_numpy
from neural_admixture_tpu_torch.train.engine import NeuralAdmixtureTrainer
from tests.conftest import DEMO_BED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-6)


def _params(seed, m, m_pad, D, H, ks):
    """JAX-initialised parameters as numpy, V seeded with numpy."""
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(m, D)) * 0.1).astype(np.float32)
    p = jqp.init_params(jax.random.PRNGKey(seed), V, None, H, list(ks),
                        m_pad=m_pad)
    return jax.tree.map(np.asarray, p)


def _packed(seed, N, M):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    return pack_with_padding(G)


def test_encoder_matches_encode_from_xp():
    params = _params(0, 100, 2048, 4, 32, (3, 5))
    Xp = np.random.default_rng(1).normal(size=(11, 4)).astype(np.float32)
    want = jqp.encode_from_xp(params, jnp.asarray(Xp))
    model = params_from_numpy(params, [5, 3])
    with torch.no_grad():
        got = model.encode_from_xp(torch.from_numpy(Xp))
    assert list(got) == ["k3", "k5"]
    for hk in want:
        np.testing.assert_allclose(got[hk].numpy(), np.asarray(want[hk]),
                                   **TOL)


def test_reference_state_dict_loads_into_encoder():
    """The reference's state-dict names are the module's own."""
    ks = [3, 5]
    params = _params(2, 100, 2048, 4, 32, ks)
    sd = torch_state_dict_from_params(params)
    model = QPEncoder(2048, 4, 32, ks)
    model.load_state_dict(sd)
    ref = params_from_numpy(params, ks)
    for (n1, p1), (n2, p2) in zip(model.state_dict().items(),
                                  ref.state_dict().items()):
        assert n1 == n2
        torch.testing.assert_close(p1, p2, rtol=0, atol=0)


@pytest.mark.parametrize("force_pallas", ["0", "1"])
@pytest.mark.parametrize("ks", [(3,), (2, 3, 5)])
def test_infer_q_matches_jax(monkeypatch, force_pallas, ks):
    packed, m_pad = _packed(3, 21, 500)
    params = _params(3, 500, m_pad, 4, 32, ks)
    monkeypatch.setenv("NA_TPU_FORCE_PALLAS", force_pallas)
    want = jinfer_q(params, packed, 21, list(ks), batch_size=8)
    got = infer_q(params, packed, 21, list(ks), batch_size=8, device="cpu")
    assert len(got) == len(want) == len(ks)
    for g, w, k in zip(got, want, sorted(ks)):
        assert g.shape == (21, k)
        np.testing.assert_allclose(g, w, **TOL)


def _demo_model(d, name, ks, pt=False):
    """A seeded checkpoint for the demo BED, written by the JAX package."""
    _, M = read_bed_dims(DEMO_BED)
    m_pad = -(-M // 2048) * 2048
    params = _params(4, M, m_pad, 8, 64, ks)
    if pt:
        save_pt_checkpoint(params, name, str(d), num_snps=M)
    else:
        save_checkpoint(params, name, str(d))
    save_config(name, str(d), ks=sorted(ks), num_features=m_pad,
                hidden_size=64, num_snps=M)


def _infer_argv(d, name, out):
    return ["infer", "--name", name, "--save_dir", str(d), "--data_path",
            DEMO_BED, "--out_name", out]


@pytest.mark.parametrize("ks,pt", [([4], False), ([4], True),
                                   ([2, 3, 4], False), ([2, 5], False)])
def test_cli_infer_matches_jax(tmp_path, ks, pt):
    _demo_model(tmp_path, "m", ks, pt)
    assert jentry.main(_infer_argv(tmp_path, "m", "jax")) == 0
    assert tentry.main(_infer_argv(tmp_path, "m", "port")
                       + ["--num_gpus", "0"]) == 0
    for k in ks:
        want = np.loadtxt(tmp_path / f"jax.{k}.Q")
        got = np.loadtxt(tmp_path / f"port.{k}.Q")
        assert got.shape == want.shape == (105, k)
        np.testing.assert_allclose(got, want, **TOL)
    assert sorted(p.name for p in tmp_path.glob("port.*.Q")) == \
        sorted(f"port.{k}.Q" for k in ks)


def test_port_imports_neither_jax_nor_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neural_admixture_tpu_torch as p\n"
        "import neural_admixture_tpu_torch.entry, "
        "neural_admixture_tpu_torch.infer\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'neural_admixture_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_infer_on_card_without_cuda_exits_nonzero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "neural_admixture_tpu_torch.entry",
         *_infer_argv(tmp_path, "m", "o"), "--num_gpus", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not list(tmp_path.glob("*.Q"))


def test_infer_q_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed, m_pad = _packed(5, 4, 100)
    params = _params(5, 100, m_pad, 4, 8, (2,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_q(params, packed, 4, [2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.main(_infer_argv("unused", "m", "o"))


class _ReachedTraining(Exception):
    pass


def _reached_training(trainer, *args, **kwargs):
    raise _ReachedTraining(f"training with seed {trainer.cfg.seed}")


@pytest.mark.parametrize("argv,cards,exc,match", [
    # Restarts run: the first reaches training with --seed.
    (["train", "--k", "3", "--save_dir", "s", "--data_path", DEMO_BED,
      "--name", "m", "--init_restarts", "2", "--num_gpus", "0"], None,
     _ReachedTraining, "training with seed 42"),
    # Several cards on a host without one: no CUDA device, no CPU run.
    (["infer", "--num_gpus", "2"], None, RuntimeError,
     "--num_gpus 2 asks for CUDA devices, but no CUDA device"),
    # Three cards asked of one: the clamp, then the one card's check.
    (["infer", "--num_gpus", "3"], 1, RuntimeError,
     "--num_gpus 1 asks for a CUDA device, but no CUDA device"),
])
def test_unported_paths_raise(monkeypatch, argv, cards, exc, match):
    monkeypatch.setattr(NeuralAdmixtureTrainer, "launch_training",
                        _reached_training)
    if cards is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if argv[0] == "infer":
        argv = _infer_argv("unused", "m", "o") + argv[1:]
    with pytest.raises(exc, match=match):
        tentry.main(argv)


def test_cli_infer_mesh_1x1_is_one_device(tmp_path):
    """--mesh 1x1 is one device, as in the JAX package (infer.py:130-132):
    the same .Q as no mesh; '2x' fails the format check."""
    _demo_model(tmp_path, "m", [3])
    argv = _infer_argv(tmp_path, "m", "plain") + ["--num_gpus", "0"]
    assert tentry.main(argv) == 0
    argv[argv.index("--out_name") + 1] = "mesh"
    assert tentry.main(argv + ["--mesh", "1x1"]) == 0
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "mesh.3.Q"),
                                  np.loadtxt(tmp_path / "plain.3.Q"))
    with pytest.raises(ValueError, match="--mesh must look like"):
        tentry.main(argv + ["--mesh", "2x"])


def test_unported_reader_raises(tmp_path):
    """Every input format of the JAX package is ported; any other suffix
    logs its error and exits 1, as the JAX package's infer does."""
    _demo_model(tmp_path, "m", [3])
    argv = _infer_argv(tmp_path, "m", "o") + ["--num_gpus", "0"]
    argv[argv.index("--data_path") + 1] = str(tmp_path / "x.txt")
    with pytest.raises(SystemExit) as info:
        tentry.main(argv)
    assert info.value.code == 1
    assert not list(tmp_path.glob("o.*"))


def test_yaml_config_defaults(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("batch_size: '7'\nnum_gpus: 0\nname: m\n")
    args = tentry.parse_infer_args(["--config", str(cfg), "--out_name", "o",
                                    "--save_dir", "s", "--data_path", "d"])
    assert (args.batch_size, args.num_gpus, args.name) == (7, 0, "m")
    args = tentry.parse_infer_args(["--out_name", "o", "--save_dir", "s",
                                    "--data_path", "d", "--name", "m"])
    assert args.num_gpus == 1  # the card unless the caller asks for the CPU
