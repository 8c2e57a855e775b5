"""``--cv`` in the port (train/cv.py) against the JAX package's train/cv.py,
on the CPU.

  * the k-fold splits equal the JAX package's and sklearn's
    KFold(shuffle=True, random_state=seed), every sample validating once;
  * one fold from identical inputs (the JAX fold's V, its GMM P init, its
    initial parameters and batch plans): the fold's P and held-out Q follow
    ``assert_trajectory_close`` against the JAX fold's, its cv_error within
    rtol 1e-4; from the JAX fold's trained parameters and Ps, the port's
    held-out projection and cv_error within rtol 2e-5;
  * the report: for the same per-fold errors, the csv text, the ``CV
    error`` lines and the ``Lowest CV error`` line equal the JAX package's;
  * the CLI: ``--cv 3 --min_k 2 --max_k 3`` writes the csv and the plot,
    and the .Q/.P of the same run without ``--cv`` (traced with
    ``--profile_dir``) byte for byte; supervised ``--cv`` runs.
"""
import importlib
import logging
import os

import jax
import numpy as np
import pytest

from neural_admixture_tpu.infer import infer_q as jinfer_q
from neural_admixture_tpu.ops.loglikelihood import (
    loglikelihood_packed as jloglik_packed)
from neural_admixture_tpu.ops.rsvd import rsvd as jrsvd
from neural_admixture_tpu.train import cv as jcv
from neural_admixture_tpu.train import engine as jengine
from neural_admixture_tpu.train.init import init_p_unsupervised as jinit_p
from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.infer import infer_q
from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.train import cv as tcv
from neural_admixture_tpu_torch.train.engine import TrainConfig
from tests.conftest import DEMO_BED, DEMO_Q_EXPECTED, assert_trajectory_close
from tests.test_torch_port_train import _jax_init_and_plans

N, M, KS, H, D, B, LR, SEED, FOLDS = 90, 6000, [2, 3], 32, 4, 24, 2e-3, 5, 3


@pytest.mark.parametrize("n,folds,seed", [(23, 3, 0), (40, 5, 42),
                                          (11, 2, 7), (105, 10, 3)])
def test_kfold_matches_jax_and_sklearn(n, folds, seed):
    sklearn_ms = pytest.importorskip("sklearn.model_selection")
    got = tcv.kfold_indices(n, folds, seed)
    ref = sklearn_ms.KFold(n_splits=folds, shuffle=True, random_state=seed)
    for (tr, va), (jtr, jva), (tr_r, va_r) in zip(
            got, jcv.kfold_indices(n, folds, seed), ref.split(np.zeros(n))):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
        np.testing.assert_array_equal(tr, np.sort(tr_r))
        np.testing.assert_array_equal(va, np.sort(va_r))
    assert sorted(np.concatenate([v for _, v in got]).tolist()) == \
        list(range(n))


def test_kfold_refuses_the_jax_packages_fold_counts():
    for folds in (1, N + 1):
        with pytest.raises(ValueError, match="--cv needs between 2 and"):
            tcv.kfold_indices(N, folds, 0)


@pytest.fixture(scope="module")
def jax_fold():
    """Fold 0 of the JAX package's run_cross_validation, step by step as
    its train/cv.py:84-104 runs it (the XLA path on one device)."""
    G = np.random.default_rng(21).integers(0, 4, size=(N, M)).astype(
        np.uint8)
    packed, m_pad = pack_with_padding(G)
    tr_idx, val_idx = jcv.kfold_indices(N, FOLDS, SEED)[0]
    packed_tr = np.ascontiguousarray(packed[tr_idx])
    packed_val = np.ascontiguousarray(packed[val_idx])
    n_tr, n_val = tr_idx.size, val_idx.size
    V = jrsvd(packed_tr, n_tr, M, D, SEED)
    P_init = jinit_p(packed_tr, V, n_tr, M, KS, SEED)
    cfg = dict(epochs=2, batch_size=B, learning_rate=LR, seed=SEED,
               hidden_size=H, n_components=D, ks=KS, progress=False,
               sample_block=8)
    _, Ps, params = jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        use_pallas=False, mesh_shape=(1, 1), **cfg)).launch_training(
            P_init, packed_tr, V, M, n_tr)
    params = jax.tree.map(np.asarray, params)
    q_val = jinfer_q(params, packed_val, n_val, KS)
    errors = [-float(jloglik_packed(
        packed_val, M, np.ascontiguousarray(P.astype(np.float64)),
        np.ascontiguousarray(q.astype(np.float64)))) / n_val
        for P, q in zip(Ps, q_val)]
    init, plans = _jax_init_and_plans(SEED, V, P_init, H, KS, m_pad, n_tr, B,
                                      8, 2)
    return dict(packed_tr=packed_tr, packed_val=packed_val, V=V,
                P_init=P_init, cfg=cfg, Ps=Ps, params=params, q_val=q_val,
                errors=errors, init=init, plans=plans)


def test_one_fold_tracks_the_jax_fold(jax_fold):
    j = jax_fold
    fold = tcv.run_fold(
        j["packed_tr"], j["packed_val"], M, KS, SEED,
        TrainConfig(device="cpu", **j["cfg"]), V=j["V"], P_init=j["P_init"],
        init_params=j["init"], plans=lambda e: j["plans"][e])
    assert set(fold.seconds) == {"train", "project", "ll"}
    for i in range(len(KS)):
        assert_trajectory_close(fold.Ps[i], j["Ps"][i], LR)
        assert_trajectory_close(fold.q_val[i], j["q_val"][i], LR)
    np.testing.assert_allclose(fold.errors, j["errors"], rtol=1e-4)


def test_held_out_errors_from_the_jax_fold_params(jax_fold):
    j = jax_fold
    packed_val = j["packed_val"]
    q_val = infer_q(j["params"], packed_val, packed_val.shape[0], KS,
                    device="cpu")
    for got, want in zip(q_val, j["q_val"]):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        tcv.held_out_errors(packed_val, M, j["Ps"], q_val), j["errors"],
        rtol=2e-5)


def test_the_report_equals_the_jax_packages(monkeypatch, tmp_path, caplog):
    """The same per-fold errors give the JAX package's csv text and log
    lines: its fold loop is fed fixed log-likelihoods, the port's fold
    function returns the same errors."""
    # The modules (their packages export functions of the same names).
    jinfer, jll, jr, jinit = (importlib.import_module(
        f"neural_admixture_tpu.{m}") for m in (
            "infer", "ops.loglikelihood", "ops.rsvd", "train.init"))
    n, ks = 40, [2, 3, 4]
    rng = np.random.default_rng(8)
    lls = iter(-rng.uniform(1e3, 2e3, size=3 * len(ks)))
    table = []

    class FakeTrainer:
        def __init__(self, cfg):
            pass

        def launch_training(self, *a, **kw):
            return None, [np.zeros(1)] * len(ks), None

    def fake_ll(*a, **kw):
        table.append(next(lls))
        return table[-1]

    monkeypatch.setattr(jr, "rsvd", lambda *a, **kw: None)
    monkeypatch.setattr(jinit, "init_p_unsupervised", lambda *a, **kw: None)
    monkeypatch.setattr(jengine, "NeuralAdmixtureTrainer", FakeTrainer)
    monkeypatch.setattr(jinfer, "infer_q",
                        lambda *a, **kw: [np.zeros(1)] * len(ks))
    monkeypatch.setattr(jll, "loglikelihood_packed", fake_ll)
    packed = np.zeros((n, 4), np.uint8)
    caplog.set_level(logging.INFO)
    (tmp_path / "jax").mkdir()
    jcv.run_cross_validation(packed, n, 16, ks, 3, 0, jengine.TrainConfig(),
                             "r", str(tmp_path / "jax"))
    jax_lines = [r.getMessage() for r in caplog.records]
    caplog.clear()
    fold_lls = iter(table)

    def fake_fold(packed_tr, packed_val, *a):
        return tcv.Fold([-next(fold_lls) / packed_val.shape[0] for _ in ks],
                        [], [], {})

    (tmp_path / "port").mkdir()
    tcv.run_cross_validation(packed, n, 16, ks, 3, 0, TrainConfig(), "r",
                             str(tmp_path / "port"), fold=fake_fold)
    port_lines = [r.getMessage() for r in caplog.records]

    def report(lines, d):
        return [ln.replace(d, "DIR") for ln in lines
                if "CV error" in ln or "Fold " in ln or "cross-valid" in ln]

    assert report(port_lines, str(tmp_path / "port")) == \
        report(jax_lines, str(tmp_path / "jax"))
    assert any("Lowest CV error at K=" in ln for ln in port_lines)
    assert (tmp_path / "port" / "r.cv_errors.csv").read_text() == \
        (tmp_path / "jax" / "r.cv_errors.csv").read_text()


def _cli(out_dir, name, *extra):
    return ["train", "--data_path", DEMO_BED, "--save_dir", str(out_dir),
            "--name", name, "--epochs", "2", "--seed", "3", "--batch_size",
            "64", "--hidden_size", "32", "--num_gpus", "0", "--no_progress",
            *extra]


def test_cli_cv_writes_the_csv_and_the_fit_of_the_run_without_it(tmp_path):
    """The run without --cv is traced (--profile_dir): neither changes the
    fit's files."""
    ks = ["--min_k", "2", "--max_k", "3"]
    assert tentry.main(_cli(tmp_path, "cv", *ks, "--cv", "3")) == 0
    assert tentry.main(_cli(tmp_path, "plain", *ks, "--profile_dir",
                            str(tmp_path / "trace"))) == 0
    assert [p.name for p in (tmp_path / "trace").iterdir()] == [
        "epochs_rank0.json"]
    rows = [ln.split(",") for ln in (tmp_path / "cv.cv_errors.csv")
            .read_text().strip().splitlines()]
    assert rows[0] == ["K", "cv_error_mean", "cv_error_std"]
    assert [r[0] for r in rows[1:]] == ["2", "3"]
    for r in rows[1:]:
        assert np.isfinite(float(r[1])) and float(r[1]) > 0
        assert np.isfinite(float(r[2]))
    pytest.importorskip("matplotlib")
    assert (tmp_path / "cv.cv_errors.png").stat().st_size > 0
    for k in (2, 3):
        for m in ("Q", "P"):
            assert (tmp_path / f"cv.{k}.{m}").read_bytes() == \
                (tmp_path / f"plain.{k}.{m}").read_bytes()
    assert not (tmp_path / "plain.cv_errors.csv").exists()


def test_cli_supervised_cv(tmp_path):
    """Labels from the argmax of the reference's K = 7 Q (5 populations)."""
    labels = [f"P{j}" for j in np.genfromtxt(DEMO_Q_EXPECTED).argmax(1)]
    pops = tmp_path / "labels.txt"
    pops.write_text("\n".join(labels) + "\n")
    k = len(set(labels))
    assert tentry.main(_cli(tmp_path, "sup", "--k", str(k), "--pops_path",
                            str(pops), "--cv", "3")) == 0
    rows = (tmp_path / "sup.cv_errors.csv").read_text().strip().splitlines()
    assert rows[1].split(",")[0] == str(k)
    assert np.isfinite(float(rows[1].split(",")[1]))
    assert os.path.exists(tmp_path / f"sup.{k}.Q")
