"""The PyTorch port's training path against the JAX package, on the CPU.

Both packages get the same inputs (numpy, from a seed): the loss and every
gradient against ``jax.value_and_grad`` of the engine's ``_loss_fn``
(XLA path); the two-Function op against plain autograd; the RSVD, the PCA
projection and the GMM's EM; two epochs of training from the same initial
parameters and batch plans, gated by ``assert_trajectory_close``; and the
``train`` CLI on the demo BED.

Tolerances: single ops rtol 2e-5 (fp32 in another summation order),
gradients of sums over ~10^5 terms rtol 1e-4 of the largest element,
trajectories by the Adam-aware rule of tests/conftest.py.
"""
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_admixture_tpu.io.bed import read_bed_packed as jread_bed
from neural_admixture_tpu.io.torch_interop import (
    torch_state_dict_from_params as jstate_dict)
from neural_admixture_tpu.models import qp as jqp
from neural_admixture_tpu.ops import gmm as jgmm
from neural_admixture_tpu.ops.loglikelihood import (
    loglikelihood_packed as jloglik_packed)
from neural_admixture_tpu.ops.rsvd import rsvd as jrsvd
from neural_admixture_tpu.train import engine as jengine
from neural_admixture_tpu.train.init import init_p_unsupervised as jinit_p
from neural_admixture_tpu.train.init import pca_coords as jpca_coords
from neural_admixture_tpu.utils.metrics import fst_table as jfst_table
from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.infer import infer_q
from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.io.torch_interop import (
    torch_state_dict_from_params)
from neural_admixture_tpu_torch.io.writers import load_checkpoint
from neural_admixture_tpu_torch.models.qp import params_from_numpy
from neural_admixture_tpu_torch.ops.fused import unpack_dosage
from neural_admixture_tpu_torch.ops.fused_step import fused_training_loss
from neural_admixture_tpu_torch.ops.gmm import fit_gmm
from neural_admixture_tpu_torch.ops.loglikelihood import loglikelihood_packed
from neural_admixture_tpu_torch.ops.loss import clamped_bce_sum
from neural_admixture_tpu_torch.ops.rsvd import rsvd
from neural_admixture_tpu_torch.train.engine import (
    NeuralAdmixtureTrainer, TrainConfig, block_geometry, epoch_plan)
from neural_admixture_tpu_torch.train.init import project_pca
from neural_admixture_tpu_torch.utils.metrics import fst_table
from neural_admixture_tpu_torch.utils.seeding import generator
from tests.conftest import (DEMO_BED, DEMO_P_EXPECTED, DEMO_Q_EXPECTED,
                            assert_trajectory_close)
from tests.test_train_demo import best_permutation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_LL = -326_814  # tests/test_train_demo.py:77-86


def _genotypes(seed, N, M, missing=True):
    return np.random.default_rng(seed).integers(
        0, 4 if missing else 3, size=(N, M)).astype(np.uint8)


def _jax_params(seed, V_MD, P_init, H, ks, m_pad):
    p = jqp.init_params(jax.random.PRNGKey(seed), V_MD, P_init, H, ks,
                        m_pad=m_pad)
    return jax.tree.map(np.asarray, p)


def _setup(seed=0, B=24, M=900, D=4, H=16, K=3):
    G = _genotypes(seed, B, M)
    packed, m_pad = pack_with_padding(G)
    rng = np.random.default_rng(seed + 1)
    V = (rng.normal(size=(M, D)) * 0.05).astype(np.float32)
    P_init = rng.uniform(0.02, 0.98, size=(K, M)).astype(np.float32)
    params = _jax_params(seed, V, P_init, H, [K], m_pad)
    col_mask = (np.arange(m_pad) < M).astype(np.float32)
    row_w = (rng.uniform(size=B) > 0.25).astype(np.float32)
    return packed, params, col_mask, row_w


def _port_grads(model):
    g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return {"V": g["V"], "rmsnorm/weight": g["batch_norm.weight"],
            "common/kernel": g["common_encoder.0.weight"].T,
            "common/bias": g["common_encoder.0.bias"],
            "heads/k3/kernel": g["multihead_encoder.heads.0.weight"].T,
            "heads/k3/bias": g["multihead_encoder.heads.0.bias"],
            "decoders/k3": g["decoders.k3"]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name in want:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_loss_and_grads_match_jax_loss_fn():
    packed, params, cm, rw = _setup()
    loss_j, grads_j = jax.value_and_grad(jengine._loss_fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(packed),
        jnp.asarray(rw), jnp.asarray(cm), jnp.zeros(packed.shape[0],
                                                    jnp.int32),
        supervised=False, supervised_loss_weight=0.0, use_pallas=False)
    model = params_from_numpy(params, [3])
    X = unpack_dosage(torch.from_numpy(packed))
    recs, _ = model.forward_train(X)
    loss = clamped_bce_sum(recs["k3"], X, torch.from_numpy(cm),
                           torch.from_numpy(rw))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _assert_grads_close(_port_grads(model), _flat(grads_j))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("logged", [True, False])
def test_two_function_op_matches_plain_autograd(masked, logged):
    packed, params, cm, rw = _setup(seed=3)
    if not masked:
        rw = np.ones_like(rw)  # the unmasked op is for all-real batches
    cm_t, rw_t = torch.from_numpy(cm), torch.from_numpy(rw)
    pk = torch.from_numpy(packed)
    ref = params_from_numpy(params, [3])
    X = unpack_dosage(pk)
    recs, _ = ref.forward_train(X)
    want_loss = clamped_bce_sum(recs["k3"], X, cm_t, rw_t)
    want_loss.backward()
    model = params_from_numpy(params, [3])
    loss, qs = fused_training_loss(model, pk, cm_t, rw_t, masked,
                                   no_missing=False, logged=logged)
    (2.5 * loss).backward()  # a loss cotangent other than 1
    if logged:
        np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-5)
    else:
        assert loss.item() == 0.0
    want = {k: 2.5 * v for k, v in _port_grads(ref).items()}
    _assert_grads_close(_port_grads(model), want)


@pytest.mark.parametrize("missing", [True, False])
def test_rsvd_matches_jax(missing):
    N, M = 60, 700
    G = _genotypes(4, N, M, missing)
    packed, m_pad = pack_with_padding(G)
    want = jrsvd(packed, N, M, k=5, seed=7)
    got = rsvd(torch.from_numpy(packed), N, M, k=5, seed=7,
               block_bytes=4 * m_pad * 7)  # 7-row blocks
    assert got.shape == want.shape == (5, M)
    for c in range(5):
        np.testing.assert_allclose(got[c], want[c], rtol=0,
                                   atol=2e-4 * np.abs(want[c]).max(),
                                   err_msg=f"component {c}")


def test_project_pca_matches_jax():
    N, M = 33, 500
    packed, _ = pack_with_padding(_genotypes(5, N, M))
    V = np.random.default_rng(6).normal(size=(3, M)).astype(np.float32)
    want = np.asarray(jpca_coords(packed, V, N))
    got = project_pca(torch.from_numpy(packed), V, N,
                      block_bytes=4 * packed.shape[1] * 4 * 5).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("device_threshold", [2e10, 0])
def test_loglikelihood_packed_matches_jax(device_threshold):
    """The host f64 path agrees to rounding; the blocked fp32 path (on the
    CPU here) to rtol 1e-6, both against the JAX package's host path."""
    N, M, K = 50, 700, 4
    packed, _ = pack_with_padding(_genotypes(12, N, M))
    rng = np.random.default_rng(13)
    P = rng.uniform(0.0, 1.0, size=(M, K))
    Q = rng.dirichlet(np.ones(K), size=N)
    want = jloglik_packed(packed, M, P, Q)
    got = loglikelihood_packed(packed, M, P, Q,
                               device_threshold=device_threshold)
    np.testing.assert_allclose(got, want,
                               rtol=1e-12 if device_threshold else 1e-6)


def test_pt_export_and_fst_table_match_jax():
    """The decoder-stripped .pt state dict (V cut to exactly M rows) and the
    Fst display lines are the JAX package's, key for key and line for line."""
    _, params, _, _ = _setup(seed=14, M=900)
    want = jstate_dict(params, num_snps=900)
    got = torch_state_dict_from_params(params, num_snps=900)
    assert list(got) == list(want) and got["V"].shape == (900, 4)
    for key, t in want.items():
        torch.testing.assert_close(got[key], t, rtol=0, atol=0)
    P = np.random.default_rng(15).uniform(size=(900, 5))
    assert fst_table(P) == jfst_table(P)


def _jax_em(X, resp0, tol=1e-4, max_iter=100, reg=1e-6):
    """The JAX package's EM (ops/gmm.py _fit_single after its seeding)."""
    means, covs, weights = jgmm._m_step(X, resp0, reg)
    prev, lb, it = -np.inf, np.inf, 0
    while it < max_iter and abs(lb - prev) >= tol:
        wlp = jgmm._log_gauss(X, means, covs) + jnp.log(weights)[None, :]
        lse = jax.scipy.special.logsumexp(wlp, axis=1)
        resp = jnp.exp(wlp - lse[:, None])
        means, covs, weights = jgmm._m_step(X, resp, reg)
        prev, lb, it = lb, float(jnp.mean(lse)), it + 1
    wlp = jgmm._log_gauss(X, means, covs) + jnp.log(weights)[None, :]
    lb = float(jnp.mean(jax.scipy.special.logsumexp(wlp, axis=1)))
    return means, covs, weights, lb, it


def test_gmm_em_matches_jax_from_identical_responsibilities():
    rng = np.random.default_rng(8)
    K, D, R = 3, 4, 3
    centers = rng.normal(scale=3.0, size=(K, D))
    X = (centers[rng.integers(0, K, 240)]
         + rng.normal(size=(240, D))).astype(np.float32)
    resp0 = np.eye(K, dtype=np.float32)[rng.integers(0, K, (R, 240))]
    runs = [_jax_em(jnp.asarray(X), jnp.asarray(r)) for r in resp0]
    best = int(np.argmax([r[3] for r in runs]))
    got = fit_gmm(torch.from_numpy(X), K, n_init=R,
                  resp0=torch.from_numpy(resp0))
    means, covs, weights, lb, it = runs[best]
    assert int(got.n_iter) == it
    np.testing.assert_allclose(float(got.lower_bound), lb, rtol=1e-5)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(means),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.covariances.numpy(), np.asarray(covs),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(weights),
                               rtol=1e-4, atol=1e-6)


def test_gmm_seeding_is_deterministic_and_finds_the_clusters():
    rng = np.random.default_rng(9)
    centers = np.array([[0, 0], [10, 0], [0, 10]], np.float32)
    X = torch.from_numpy((centers[np.repeat(np.arange(3), 50)]
                          + rng.normal(size=(150, 2))).astype(np.float32))
    a = fit_gmm(X, 3, generator(1, 3))
    b = fit_gmm(X, 3, generator(1, 3))
    torch.testing.assert_close(a.means, b.means, rtol=0, atol=0)
    dist = np.linalg.norm(a.means.numpy()[:, None] - centers[None], axis=-1)
    assert sorted(dist.argmin(1)) == [0, 1, 2] and dist.min(1).max() < 0.5


def _jax_plan(key, N, batch_size, blk, n_rows):
    """The JAX engine's epoch plan from its key (engine.py:465-493)."""
    b_round, nb, b_rem, _ = block_geometry(N, batch_size, blk)
    if blk > 1:
        F = b_round // blk
        perm = np.asarray(jax.random.permutation(key, N // blk))
        return (perm[:(nb - 1) * F].reshape(nb - 1, F),
                np.concatenate([perm[(nb - 1) * F:],
                                np.arange(N // blk, n_rows // blk)]))
    perm = np.asarray(jax.random.permutation(key, N))
    tail = perm[(nb - 1) * batch_size:]
    return (perm[:(nb - 1) * batch_size].reshape(nb - 1, batch_size),
            np.concatenate([tail, np.full(b_rem - tail.size, N)]))


def _jax_init_and_plans(seed, V, P_init, H, ks, m_pad, N, batch_size, blk,
                        epochs):
    """The JAX engine's initial parameters and epoch plans, recomputed from
    its key stream (engine.py:919-920, :1395)."""
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    params = jax.tree.map(np.asarray, jqp.init_params(
        k_init, np.asarray(V).T, P_init, H, ks, m_pad=m_pad))
    _, _, _, n_rows = block_geometry(N, batch_size, blk)
    plans = []
    for _ in range(epochs):
        key, k_epoch = jax.random.split(key)
        plans.append(_jax_plan(k_epoch, N, batch_size, blk, n_rows))
    return params, plans


def _jax_losses(caplog):
    return [float(r.getMessage().rsplit(" ", 1)[1].replace(",", ""))
            for r in caplog.records if "Loss in epoch" in r.getMessage()]


@pytest.mark.parametrize("blk", [16, 1])
def test_two_epochs_track_jax_engine(caplog, blk):
    N, M, K, H, D, B, lr, seed = 100, 6000, 3, 32, 4, 40, 2e-3, 5
    G = _genotypes(10, N, M)
    packed, m_pad = pack_with_padding(G)
    rng = np.random.default_rng(11)
    V = (rng.normal(size=(D, M)) / np.sqrt(M)).astype(np.float32)
    P_init = rng.uniform(0.05, 0.95, size=(K, M)).astype(np.float32)
    kw = dict(epochs=2, batch_size=B, learning_rate=lr, seed=seed,
              hidden_size=H, n_components=D, ks=[K], progress=False,
              sample_block=blk)
    caplog.set_level(logging.INFO)
    jtr = jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        use_pallas=False, mesh_shape=(1, 1), **kw))
    Qj, Pj, pj = jtr.launch_training(P_init, packed, V, M, N)
    (loss_j,) = _jax_losses(caplog)

    params, plans = _jax_init_and_plans(seed, V, P_init, H, [K], m_pad, N, B,
                                        blk, 2)
    tr = NeuralAdmixtureTrainer(TrainConfig(device="cpu", **kw))
    Qt, Pt, pt = tr.launch_training(P_init, packed, V, M, N,
                                    init_params=params,
                                    plans=lambda e: plans[e])
    np.testing.assert_allclose(tr.logged_losses[0], loss_j, rtol=1e-5)
    assert loss_j > 1e5  # the logged value is rounded to an integer
    assert_trajectory_close(Pt[0], Pj[0], lr)
    assert_trajectory_close(Qt[0], Qj[0], lr)
    for name, want in _flat(pj).items():
        assert_trajectory_close(_flat(pt)[name], want, lr)


def _demo_gates(Q, P):
    Q_ref = np.genfromtxt(DEMO_Q_EXPECTED)
    P_ref = np.genfromtxt(DEMO_P_EXPECTED)
    perm, matched = best_permutation(Q, Q_ref)
    assert np.mean(matched) > 0.78, matched
    assert np.sort(matched)[1] > 0.85, matched
    p_corr = [np.corrcoef(P[:, perm[j]], P_ref[:, j])[0, 1] for j in range(7)]
    assert np.mean(p_corr) > 0.93, p_corr
    assert np.min(p_corr) > 0.80, p_corr


def test_demo_gates_from_the_jax_init():
    """The port, started from the JAX package's RSVD, P init, encoder init
    and batch plans at seed 42 (its CLI defaults), passes the demo's
    golden gates (tests/test_train_demo.py:62-86)."""
    packed, N, M = jread_bed(DEMO_BED)
    V = jrsvd(packed, N, M, 8, 42)
    P_init = jinit_p(packed, V, N, M, [7], 42)
    params, plans = _jax_init_and_plans(42, V, P_init, 1024, [7],
                                        packed.shape[1] * 4, N, 800, 16, 5)
    tr = NeuralAdmixtureTrainer(TrainConfig(
        epochs=5, seed=42, ks=[7], progress=False, sample_block=16,
        device="cpu"))
    Qs, Ps, _ = tr.launch_training(P_init, packed, V, M, N,
                                   init_params=params,
                                   plans=lambda e: plans[e])
    ll = loglikelihood_packed(packed, M, Ps[0], Qs[0])
    assert ll > GOLDEN_LL, ll
    _demo_gates(Qs[0], Ps[0])


def test_cli_train_on_demo_bed(tmp_path):
    argv = ["train", "--k", "7", "--data_path", DEMO_BED, "--save_dir",
            str(tmp_path), "--name", "demo", "--epochs", "5", "--seed", "42",
            "--num_gpus", "0", "--no_progress"]
    assert tentry.main(argv) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["demo.7.P", "demo.7.Q", "demo.npz", "demo.pt",
                     "demo_config.json"]
    Q = np.loadtxt(tmp_path / "demo.7.Q")
    P = np.loadtxt(tmp_path / "demo.7.P")
    assert Q.shape == (105, 7) and P.shape == (8451, 7)
    np.testing.assert_allclose(Q.sum(1), 1.0, rtol=1e-4)
    assert P.min() >= 0.0 and P.max() <= 1.0
    packed, N, M = jread_bed(DEMO_BED)
    ll = loglikelihood_packed(packed, M, P, Q)
    assert np.isfinite(ll) and ll < 0
    # The .npz loads into the port's own infer and gives the trained Q.
    params = load_checkpoint("demo", str(tmp_path))
    (Qi,) = infer_q(params, packed, N, [7], device="cpu")
    np.testing.assert_allclose(Qi, Q, rtol=1e-4, atol=1e-6)


def test_cli_train_logs_the_input_format(tmp_path, caplog):
    """The JAX package's train/run.py:162-169: "Input format is BED." just
    before the "Data contains" line."""
    argv = ["train", "--k", "3", "--data_path", DEMO_BED, "--save_dir",
            str(tmp_path), "--name", "fmt", "--epochs", "1", "--seed", "42",
            "--num_gpus", "0", "--no_progress"]
    caplog.set_level(logging.INFO)
    assert tentry.main(argv) == 0
    lines = [r.getMessage() for r in caplog.records]
    i = lines.index("    Input format is BED.")
    assert lines[i + 1] == "    Data contains 105 samples and 8451 SNPs."


def test_cli_train_on_card_without_cuda_exits_nonzero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "neural_admixture_tpu_torch.entry", "train",
         "--k", "3", "--data_path", DEMO_BED, "--save_dir", str(tmp_path),
         "--name", "m", "--epochs", "1", "--num_gpus", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not list(tmp_path.iterdir())


class _PastTheStreamCheck(Exception):
    pass


def _past_the_checks(trainer, *args, **kwargs):
    raise _PastTheStreamCheck(f"training with profile_dir "
                              f"{trainer.cfg.profile_dir}")


@pytest.mark.parametrize("extra,exc,match", [
    # The JAX package's checks (entry.py:295-298).
    (["--cv", "1"], ValueError, "folds must be >= 2"),
    (["--init_restarts", "0"], ValueError, "init_restarts must be >= 1"),
    # The trace reaches training.
    (["--profile_dir", "t"], _PastTheStreamCheck,
     "training with profile_dir t"),
    # Several cards on a host without one: no CUDA device, no CPU run.
    (["--num_gpus", "2"], RuntimeError, "no CUDA device"),
    # A grid refuses --cv, as the JAX package across processes.
    (["--mesh", "2x1", "--cv", "3"], ValueError,
     "--cv runs single-process"),
])
def test_unported_train_options_raise(monkeypatch, tmp_path, extra, exc,
                                      match):
    monkeypatch.setattr(NeuralAdmixtureTrainer, "launch_training",
                        _past_the_checks)
    argv = ["train", "--data_path", DEMO_BED, "--save_dir", str(tmp_path),
            "--name", "m", "--num_gpus", "0", "--k", "3"]
    with pytest.raises(exc, match=match):
        tentry.main(argv + extra)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("stream,verdict", [
    (2, "invalid"), ("yes", "invalid"), (0, "resident"),
    (False, "resident"), ("auto", "resident"), (None, "resident"),
    (1, "streamed"), (True, "streamed"),
])
def test_stream_values_follow_the_jax_package(monkeypatch, tmp_path, stream,
                                              verdict):
    """A --stream value (as a YAML config may give it) gets the JAX
    package's verdict: outside auto/0/1 a ValueError, else its trainer's
    ``stream`` (None, False or True); the port passes check_ported and
    hands its trainer the same value."""
    from neural_admixture_tpu.train import run as jrun

    from neural_admixture_tpu_torch.train import run as trun
    from neural_admixture_tpu_torch.train.run import check_ported

    args = tentry.parse_train_args(
        ["--data_path", DEMO_BED, "--save_dir", str(tmp_path), "--name", "m",
         "--num_gpus", "0", "--k", "3"])
    args.stream = stream

    def stop(**kw):  # the stream verdict is in kw["stream"]
        raise _PastTheStreamCheck(kw["stream"])

    monkeypatch.setattr(jrun, "TrainConfig", stop)
    with pytest.raises((ValueError, _PastTheStreamCheck)) as jax_exc:
        jrun.main_train(args, 0.0)
    jax_verdict = ("invalid" if jax_exc.type is ValueError else
                   "streamed" if jax_exc.value.args[0] else "resident")
    assert jax_verdict == verdict
    if verdict == "invalid":
        with pytest.raises(ValueError, match="--stream must be auto, 0, or 1"):
            check_ported(args)
        return
    check_ported(args)
    monkeypatch.setattr(trun, "TrainConfig", stop)
    with pytest.raises(_PastTheStreamCheck) as port_exc:
        trun.main_train(args, 0.0)
    assert port_exc.value.args[0] is jax_exc.value.args[0]


def test_cli_train_mesh_1x1_is_one_device(tmp_path):
    """--mesh 1x1 trains on the one device --num_gpus names, as the JAX
    package does (train/run.py:45-54): the same .Q as no mesh; '2x' fails
    the format check (entry.py:280-284)."""
    argv = ["train", "--k", "3", "--data_path", DEMO_BED, "--save_dir",
            str(tmp_path), "--epochs", "2", "--seed", "42", "--num_gpus",
            "0", "--no_progress"]
    assert tentry.main(argv + ["--name", "plain"]) == 0
    assert tentry.main(argv + ["--name", "mesh", "--mesh", "1x1"]) == 0
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "mesh.3.Q"),
                                  np.loadtxt(tmp_path / "plain.3.Q"))
    with pytest.raises(ValueError, match="--mesh must look like"):
        tentry.main(argv + ["--name", "m", "--mesh", "2x"])


def test_epoch_plan_covers_every_row_once():
    for N, B, blk in [(4096, 800, 16), (105, 800, 16), (100, 40, 1),
                      (37, 10, 4)]:
        b_round, nb, b_rem, n_rows = block_geometry(N, B, blk)
        idx_full, idx_rem = epoch_plan(generator(0, 1, 0), N, B, blk, n_rows)
        assert idx_full.shape == (nb - 1, b_round // blk)
        assert idx_rem.size * blk == b_rem
        rows = (np.concatenate([idx_full.ravel(), idx_rem])[:, None] * blk
                + np.arange(blk)).ravel()
        assert sorted(rows[rows < N]) == list(range(N))
        # full batches hold only real rows: they run unmasked
        assert (idx_full * blk + blk <= N).all()


def gmm_seed_lottery(seeds, restarts=200):
    """Not a test: the measurements behind ROADMAP.md Queue 3's entry on
    the demo gate. For each GMM seed, the demo's 5-epoch log-likelihood
    through the port's engine (seed-42 encoder init and plans) from the P
    init of the JAX package's GMM and of the port's; then the per-restart
    GMM lower bounds of ``restarts`` k-means++ seedings of each package.
    Run: ``JAX_PLATFORMS=cpu python -m tests.test_torch_port_train 40 52``."""
    from neural_admixture_tpu_torch.ops import gmm as tgmm
    logging.disable(logging.INFO)
    packed, N, M = jread_bed(DEMO_BED)
    V = jrsvd(packed, N, M, 8, 42)
    xj = np.array(jpca_coords(packed, V, N))
    X = torch.from_numpy(xj)

    def trained_ll(means):
        P = np.clip(np.asarray(means, np.float32) @ V, 5e-6, 1 - 5e-6)
        tr = NeuralAdmixtureTrainer(TrainConfig(
            epochs=5, seed=42, ks=[7], progress=False, sample_block=16,
            device="cpu"))
        Qs, Ps, _ = tr.launch_training(P, packed, V, M, N)
        return loglikelihood_packed(packed, M, Ps[0], Qs[0])

    lls = {"jax": [], "port": []}
    for s in seeds:
        rj = jgmm.fit_gmm(jnp.asarray(xj), 7,
                          jax.random.fold_in(jax.random.PRNGKey(s), 7))
        lls["jax"].append(trained_ll(rj.means))
        lls["port"].append(trained_ll(fit_gmm(X, 7, generator(s, 7)).means))
        print(f"GMM seed {s}: LL from the JAX GMM {lls['jax'][-1]:,.0f}, "
              f"from the port's {lls['port'][-1]:,.0f}", flush=True)
    for name, v in lls.items():
        v = np.array(v)
        print(f"{name} GMM: mean {v.mean():,.0f}, range {v.min():,.0f} .. "
              f"{v.max():,.0f}, above {GOLDEN_LL:,} in {(v > GOLDEN_LL).sum()}"
              f" of {v.size}")
    fit = jax.jit(jax.vmap(lambda k: jgmm._fit_single(
        k, jnp.asarray(xj), 7, 100, 1e-4, 1e-6)))
    lb_j = np.asarray(fit(jax.random.split(jax.random.PRNGKey(0),
                                           restarts)).lower_bound)
    gen = generator(0, 7)
    lb_t = []
    for _ in range(restarts):
        c = tgmm._kmeans_plusplus(gen, X, 7)
        resp0 = torch.nn.functional.one_hot(torch.argmin(torch.sum(
            torch.square(X[:, None] - c[None]), -1), 1), 7).float()
        lb_t.append(float(fit_gmm(X, 7, n_init=1,
                                  resp0=resp0[None]).lower_bound))
    for name, v in (("jax", lb_j), ("port", np.array(lb_t))):
        print(f"{name} GMM, {restarts} restarts: lower bound mean "
              f"{v.mean():.4f}, median {np.median(v):.4f}")


if __name__ == "__main__":
    gmm_seed_lottery(range(int(sys.argv[1]), int(sys.argv[2])))
