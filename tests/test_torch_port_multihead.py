"""Multi-head (a K range) and supervised training of the port against the
JAX package, on the CPU, and the three program choices (indexed, split,
force-masked) against the port's default program.

  * the op: loss and every gradient, heads (3, 10) so that a lexicographic
    head order ('k10' < 'k3') would show, against the engine's ``_loss_fn``
    (XLA path, with and without the supervised term) and against the JAX
    package's fused and indexed ops (``make_fused_training_loss``,
    ``make_indexed_training_loss``, interpret mode), merged and split;
  * the engine: 2 epochs at ks [2, 3, 4], and supervised at one K, against
    the JAX engine from injected init and plans under
    ``assert_trajectory_close``; the port's indexed, split and force-masked
    runs equal its default run exactly (on the CPU the plain versions are
    the same arithmetic in every program);
  * the supervised pieces (label encoding, the packed P init, label
    recovery, logging every 2 epochs) and the CLI on the demo BED with
    ``--num_gpus 0``.

Tolerances: losses rtol 1e-5 (fp32 sums in another order); gradients rtol
1e-4 of their largest element; trajectories by tests/conftest.py's rule.
"""
import json
import logging

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.infer import infer_q
from neural_admixture_tpu_torch.io.bed import read_bed_packed
from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.io.writers import load_checkpoint
from neural_admixture_tpu_torch.models.qp import head_keys, params_from_numpy
from neural_admixture_tpu_torch.ops.fused_step import fused_training_loss
from neural_admixture_tpu_torch.ops.loss import softmax_cross_entropy_sum
from neural_admixture_tpu_torch.train.engine import (
    NeuralAdmixtureTrainer, TrainConfig, smallest_head)
from neural_admixture_tpu_torch.train.init import (encode_populations,
                                                   init_p_supervised_packed)
from tests.conftest import DEMO_BED, DEMO_Q_EXPECTED, assert_trajectory_close
from tests.test_torch_port_train import _flat, _jax_init_and_plans, _jax_losses

KS = (3, 10)


def _jax_params(seed, V_MD, P_init, H, ks, m_pad):
    import jax

    from neural_admixture_tpu.models import qp as jqp
    p = jqp.init_params(jax.random.PRNGKey(seed), V_MD, P_init, H, list(ks),
                        m_pad=m_pad)
    return jax.tree.map(np.asarray, p)


def _op_case(seed=0, B=16, M=300, D=4, H=16, ks=KS, N=None):
    """Packed rows padded to the JAX package's 2048-SNP tile, params, masks
    and labels for the smallest head."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N or B, M)).astype(np.uint8)
    m_pad = -(-M // 2048) * 2048
    packed = pack_2bit_rows(G, m_pad=m_pad)
    V = (rng.normal(size=(M, D)) * 0.1).astype(np.float32)
    P_init = rng.uniform(0.05, 0.95, size=(sum(ks), M)).astype(np.float32)
    params = _jax_params(seed, V, P_init, H, ks, m_pad)
    col_mask = (np.arange(m_pad) < M).astype(np.float32)
    row_w = (rng.uniform(size=B) > 0.25).astype(np.float32)
    pops = rng.integers(0, min(ks), size=B)
    return packed, params, col_mask, row_w, pops


def _port_grads(model):
    """The port's gradients under the JAX package's parameter names."""
    g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    out = {"V": g["V"], "rmsnorm/weight": g["batch_norm.weight"],
           "common/kernel": g["common_encoder.0.weight"].T,
           "common/bias": g["common_encoder.0.bias"]}
    for i, hk in enumerate(head_keys(model.ks)):
        out[f"heads/{hk}/kernel"] = g[f"multihead_encoder.heads.{i}.weight"].T
        out[f"heads/{hk}/bias"] = g[f"multihead_encoder.heads.{i}.bias"]
        out[f"decoders/{hk}"] = g[f"decoders.{hk}"]
    return out


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name in want:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_smallest_head_is_numeric():
    from neural_admixture_tpu.train.engine import smallest_head as jsmallest
    qs = {"k10": 0, "k9": 0, "k3": 0, "k12": 0}
    assert smallest_head(qs) == jsmallest(qs) == "k3"
    assert sorted(qs)[0] == "k10"  # what a lexicographic sort would pick


def test_softmax_cross_entropy_sum_matches_jax():
    import jax.numpy as jnp

    from neural_admixture_tpu.ops.loss import softmax_cross_entropy_sum as jce
    rng = np.random.default_rng(1)
    q = rng.dirichlet(np.ones(4), size=30).astype(np.float32)
    y = rng.integers(0, 4, size=30)
    w = (rng.uniform(size=30) > 0.3).astype(np.float32)
    want = float(jce(jnp.asarray(q), jnp.asarray(y), jnp.asarray(w)))
    got = softmax_cross_entropy_sum(torch.from_numpy(q), torch.from_numpy(y),
                                    torch.from_numpy(w)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _port_loss(params, packed, cm, rw, pops, supervised, masked=True,
               merged=True, blk_idx=None, blk=1, weight=7.0):
    """The engine's step loss through the port's op (plain versions on the
    CPU), with the qs it returned."""
    model = params_from_numpy(params, KS)
    rw_t = torch.from_numpy(rw)
    loss, qs = fused_training_loss(
        model, torch.from_numpy(packed), torch.from_numpy(cm), rw_t, masked,
        False, True, merged,
        None if blk_idx is None else torch.from_numpy(blk_idx), blk)
    if supervised:
        loss = loss + weight * softmax_cross_entropy_sum(
            qs[smallest_head(qs)], torch.from_numpy(pops), rw_t)
    return model, loss, qs


@pytest.mark.parametrize("supervised", [False, True])
@pytest.mark.parametrize("merged", [True, False])
def test_multihead_op_matches_jax_loss_fn(supervised, merged):
    import jax
    import jax.numpy as jnp

    from neural_admixture_tpu.train import engine as jengine
    packed, params, cm, rw, pops = _op_case(seed=2, M=900)
    loss_j, grads_j = jax.value_and_grad(jengine._loss_fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(packed),
        jnp.asarray(rw), jnp.asarray(cm), jnp.asarray(pops, jnp.int32),
        supervised=supervised, supervised_loss_weight=7.0, use_pallas=False)
    model, loss, _ = _port_loss(params, packed, cm, rw, pops, supervised,
                                merged=merged)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _assert_grads_close(_port_grads(model), _flat(grads_j))


def _planar(params, perm):
    out = dict(params)
    out["V"] = params["V"][perm]
    out["decoders"] = {hk: P[:, perm] for hk, P in params["decoders"].items()}
    return out


def _jax_op_value_and_grads(op, params, perm, *data):
    """value_and_grad of loss + sum(q^2) (a qs cotangent too) through a
    JAX fused op on planar params; the gradients back in natural order."""
    import jax
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import pack as pk
    pp = jax.tree.map(jnp.asarray, _planar(params, perm))
    enc = {k: pp[k] for k in ("rmsnorm", "common", "heads")}

    def total(V, enc, Ps):
        loss, qs = op(V, enc, Ps, *data)
        return loss + sum(jnp.sum(q ** 2) for q in qs.values())

    val, (gV, genc, gP) = jax.value_and_grad(total, argnums=(0, 1, 2))(
        pp["V"], enc, pp["decoders"])
    inv = pk.inverse_perm(perm)
    grads = _flat({"V": np.asarray(gV)[inv], **jax.tree.map(np.asarray, genc),
                   "decoders": {hk: np.asarray(g)[:, inv]
                                for hk, g in gP.items()}})
    return float(val), grads


def _port_total(params, packed, cm, rw, masked, merged, blk_idx=None, blk=1):
    model, loss, qs = _port_loss(params, packed, cm, rw, None, False, masked,
                                 merged, blk_idx, blk)
    total = loss + sum((q ** 2).sum() for q in qs.values())
    total.backward()
    return total.item(), _port_grads(model)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("merged", [True, False])
def test_op_matches_jax_fused_op(masked, merged):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import pack as pk
    from neural_admixture_tpu.ops.fused_step import make_fused_training_loss
    packed, params, cm, rw, _ = _op_case(seed=3)
    if not masked:
        rw = np.ones_like(rw)  # the unmasked op is for all-real batches
    perm = pk.planar_perm(packed.shape[1] * 4)
    op = make_fused_training_loss(sorted(params["heads"]), masked=masked,
                                  merged_loss=merged)
    val_j, grads_j = _jax_op_value_and_grads(
        op, params, perm, jnp.asarray(pk.tiles_from_rows(
            pk.packed_view_u32(packed))), jnp.asarray(cm[perm]),
        jnp.asarray(rw))
    val, grads = _port_total(params, packed, cm, rw, masked, merged)
    np.testing.assert_allclose(val, val_j, rtol=1e-5)
    _assert_grads_close(grads, grads_j)


@pytest.mark.parametrize("merged", [True, False])
def test_indexed_op_matches_jax_indexed_op(merged):
    import jax.numpy as jnp

    from neural_admixture_tpu.ops import pack as pk
    from neural_admixture_tpu.ops.fused_step import make_indexed_training_loss
    blk, nbk = 8, 4
    packed, params, cm, _, _ = _op_case(seed=4, B=nbk * blk, N=64)
    rw = np.ones(nbk * blk, np.float32)
    blk_idx = np.random.default_rng(5).choice(64 // blk, nbk,
                                              replace=False).astype(np.int32)
    perm = pk.planar_perm(packed.shape[1] * 4)
    op = make_indexed_training_loss(sorted(params["heads"]), blk,
                                    merged_loss=merged)
    val_j, grads_j = _jax_op_value_and_grads(
        op, params, perm, jnp.asarray(pk.tiles_from_rows(
            pk.packed_view_u32(packed))), jnp.asarray(blk_idx))
    val, grads = _port_total(params, packed, cm, rw, False, merged, blk_idx,
                             blk)
    np.testing.assert_allclose(val, val_j, rtol=1e-5)
    _assert_grads_close(grads, grads_j)
    # ... and exactly the port's gathered op on the same rows
    rows = (blk_idx[:, None] * blk + np.arange(blk)).ravel()
    val_g, grads_g = _port_total(params, packed[rows], cm, rw, False, merged)
    assert val == val_g
    for name, g in grads_g.items():
        np.testing.assert_array_equal(grads[name], g, err_msg=name)


def _train_data(seed, N, M, D, ks, labels=False):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    m_pad = -(-M // 4) * 4
    V = (rng.normal(size=(D, M)) / np.sqrt(M)).astype(np.float32)
    P_init = rng.uniform(0.05, 0.95, size=(sum(ks), M)).astype(np.float32)
    pops = rng.integers(0, min(ks), size=N) if labels else None
    return pack_2bit_rows(G, m_pad=m_pad), V, P_init, pops


@pytest.mark.parametrize("ks,supervised,blk", [([2, 3, 4], False, 16),
                                               ([2, 3, 4], False, 1),
                                               ([3], True, 16)])
def test_two_epochs_track_jax_engine(caplog, ks, supervised, blk):
    from neural_admixture_tpu.train import engine as jengine
    N, M, H, D, B, lr, seed = 100, 6000, 32, 4, 40, 2e-3, 5
    packed, V, P_init, pops = _train_data(20, N, M, D, ks, supervised)
    kw = dict(epochs=2, batch_size=B, learning_rate=lr, seed=seed,
              hidden_size=H, n_components=D, ks=ks, progress=False,
              sample_block=blk, supervised_loss_weight=50.0)
    caplog.set_level(logging.INFO)
    jtr = jengine.NeuralAdmixtureTrainer(jengine.TrainConfig(
        use_pallas=False, mesh_shape=(1, 1), **kw))
    Qj, Pj, pj = jtr.launch_training(P_init, packed, V, M, N, pops=pops)
    (loss_j,) = _jax_losses(caplog)

    params, plans = _jax_init_and_plans(seed, V, P_init, H, ks,
                                        packed.shape[1] * 4, N, B, blk, 2)
    tr = NeuralAdmixtureTrainer(TrainConfig(device="cpu", **kw))
    Qt, Pt, pt = tr.launch_training(P_init, packed, V, M, N,
                                    init_params=params,
                                    plans=lambda e: plans[e], pops=pops)
    assert sorted(tr.logged_losses) == [0]
    np.testing.assert_allclose(tr.logged_losses[0], loss_j, rtol=1e-5)
    assert len(Qt) == len(Pt) == len(ks)
    for i, k in enumerate(ks):
        assert Qt[i].shape == (N, k) and Pt[i].shape == (M, k)
        assert_trajectory_close(Pt[i], Pj[i], lr)
        assert_trajectory_close(Qt[i], Qj[i], lr)
    for name, want in _flat(pj).items():
        assert_trajectory_close(_flat(pt)[name], want, lr)


def _port_run(monkeypatch, env, supervised=False, log_every=1):
    """3 epochs of 3 full batches and a remainder; returns (every output
    array, the logged losses, per step (masked, split, indexed))."""
    from neural_admixture_tpu_torch.train import engine
    for var in ("NA_TPU_INDEXED", "NA_TPU_SPLIT_LOSS", "NA_TPU_FORCE_MASKED"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    steps = []

    def spy(model, xb, cm, rw, masked, no_missing, logged, merged, blk_idx,
            blk):
        steps.append((masked, logged and not merged, blk_idx is not None))
        return fused_training_loss(model, xb, cm, rw, masked, no_missing,
                                   logged, merged, blk_idx, blk)

    monkeypatch.setattr(engine, "fused_training_loss", spy)
    ks = [3] if supervised else [2, 3, 4]
    N, M = 75, 700
    packed, V, P_init, pops = _train_data(21, N, M, 4, ks, supervised)
    tr = NeuralAdmixtureTrainer(TrainConfig(
        epochs=3, batch_size=24, learning_rate=1e-2, seed=2, hidden_size=16,
        n_components=4, ks=ks, progress=False, sample_block=8,
        log_every=log_every, device="cpu"))
    Qs, Ps, params = tr.launch_training(P_init, packed, V, M, N, pops=pops)
    return Qs + Ps + list(_flat(params).values()), tr.logged_losses, steps


@pytest.mark.parametrize("env,supervised", [
    ({"NA_TPU_INDEXED": "1"}, False),
    ({"NA_TPU_SPLIT_LOSS": "1"}, False),
    ({"NA_TPU_INDEXED": "1", "NA_TPU_SPLIT_LOSS": "1"}, False),
    ({"NA_TPU_FORCE_MASKED": "1"}, False),
    ({"NA_TPU_INDEXED": "1", "NA_TPU_SPLIT_LOSS": "1"}, True),
])
def test_program_choices_equal_the_default_run(monkeypatch, env, supervised):
    """Every epoch logged (log_every 1), so the split program runs K6 and K3
    where the default runs K4 (supervised: every 2 epochs)."""
    want, losses_want, steps_want = _port_run(monkeypatch, {}, supervised)
    got, losses, steps = _port_run(monkeypatch, env, supervised)
    logged = [0, 2] if supervised else [0, 1, 2]
    full = [i % 4 < 3 for i in range(12)]  # 3 full batches, 1 remainder
    assert [s[0] for s in steps_want] == [not f for f in full]
    assert not any(s[1] or s[2] for s in steps_want)
    assert [s[0] for s in steps] == (
        [True] * 12 if "NA_TPU_FORCE_MASKED" in env else [not f for f in full])
    assert [s[1] for s in steps] == [
        "NA_TPU_SPLIT_LOSS" in env and i // 4 in logged for i in range(12)]
    assert [s[2] for s in steps] == [
        "NA_TPU_INDEXED" in env and f for f in full]
    assert sorted(losses) == logged
    assert losses == losses_want
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_encode_populations_matches_jax():
    from neural_admixture_tpu.train.init import encode_populations as jenc
    labels = ["EUR", "AFR", "EAS", "AFR", "EUR", "EUR"]
    y, d = encode_populations(labels, 3)
    yj, dj = jenc(labels, 3)
    assert d == dj == {"AFR": 0, "EAS": 1, "EUR": 2}
    np.testing.assert_array_equal(y, yj)
    with pytest.raises(ValueError, match="not equal to the value of K"):
        encode_populations(["A", "B"], 3)


@pytest.mark.parametrize("block_rows", [7, 1000])
def test_init_p_supervised_packed_matches_jax(block_rows):
    from neural_admixture_tpu.train.init import (
        init_p_supervised_packed as jinit)
    N, M, K = 50, 700, 3
    rng = np.random.default_rng(9)
    packed = pack_2bit_rows(rng.integers(0, 4, size=(N, M)).astype(np.uint8),
                            m_pad=-(-M // 4) * 4)
    y = rng.integers(0, K, size=N)
    want = jinit(packed, y, K, M, block=block_rows)
    got = init_p_supervised_packed(torch.from_numpy(packed), y, K, M,
                                   block_bytes=block_rows * 8 * M)
    assert got.shape == (K, M) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1.0  # raw codes, missing 3 included


def test_supervised_training_recovers_labels():
    """As tests/test_supervised.py:35-55 for the JAX package."""
    from tests.test_supervised import _admixed_data
    G, labels = _admixed_data()
    N, M = G.shape
    K = 3
    y, _ = encode_populations([f"P{lab}" for lab in labels], K)
    packed = pack_2bit_rows(G, m_pad=-(-M // 4) * 4)
    P_init = init_p_supervised_packed(torch.from_numpy(packed), y, K, M)
    V = (np.random.default_rng(1).normal(size=(8, M)) * 0.1).astype(
        np.float32)
    tr = NeuralAdmixtureTrainer(TrainConfig(
        epochs=20, batch_size=64, learning_rate=5e-3, seed=0, hidden_size=64,
        ks=[K], progress=False, supervised_loss_weight=10000.0,
        device="cpu"))
    Qs, _, _ = tr.launch_training(P_init, packed, V, M, N, pops=y)
    assert (Qs[0].argmax(axis=1) == y).mean() > 0.9
    assert sorted(tr.logged_losses) == list(range(0, 20, 2))


def test_cli_k_range_on_demo_bed(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    argv = ["train", "--min_k", "2", "--max_k", "4", "--data_path", DEMO_BED,
            "--save_dir", str(tmp_path), "--name", "demo", "--epochs", "2",
            "--seed", "42", "--num_gpus", "0", "--no_progress"]
    assert tentry.main(argv) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted([f"demo.{k}.{m}" for k in (2, 3, 4)
                            for m in ("P", "Q")]
                           + ["demo.npz", "demo.pt", "demo_config.json"])
    config = json.loads((tmp_path / "demo_config.json").read_text())
    assert config["ks"] == [2, 3, 4]
    lls = [r.getMessage() for r in caplog.records
           if "Log-likelihood for K=" in r.getMessage()]
    assert [m.split("K=")[1].split(":")[0] for m in lls] == ["2", "3", "4"]
    packed, N, M = read_bed_packed(DEMO_BED)
    Qi = infer_q(load_checkpoint("demo", str(tmp_path)), packed, N,
                 [2, 3, 4], device="cpu")
    for k, q in zip((2, 3, 4), Qi):
        Q = np.loadtxt(tmp_path / f"demo.{k}.Q")
        P = np.loadtxt(tmp_path / f"demo.{k}.P")
        assert Q.shape == (N, k) and P.shape == (M, k)
        np.testing.assert_allclose(q, Q, rtol=1e-4, atol=1e-6)


def test_cli_supervised_on_demo_bed(tmp_path, caplog):
    """Labels P{argmax} of the reference's K = 7 run, one per sample."""
    caplog.set_level(logging.INFO)
    labels = [f"P{j}" for j in np.genfromtxt(DEMO_Q_EXPECTED).argmax(1)]
    pops = tmp_path / "labels.txt"
    pops.write_text("\n".join(labels) + "\n\n")  # a blank line is skipped
    out = tmp_path / "out"
    argv = ["train", "--k", str(len(set(labels))), "--pops_path", str(pops),
            "--data_path", DEMO_BED, "--save_dir", str(out), "--name", "sup",
            "--epochs", "2", "--seed", "42", "--num_gpus", "0",
            "--no_progress"]
    assert tentry.main(argv) == 0
    K = len(set(labels))
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [f"sup.{K}.P", f"sup.{K}.Q", "sup.npz", "sup.pt", "sup_config.json"])
    msgs = [r.getMessage() for r in caplog.records]
    assert any("Running Supervised Mode" in m for m in msgs)
    assert [m for m in msgs if "Loss in epoch" in m][0].split()[3] == "0"
    Q = np.loadtxt(out / f"sup.{K}.Q")
    assert Q.shape == (len(labels), K)
    np.testing.assert_allclose(Q.sum(1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("extra,error", [
    (["--min_k", "2", "--max_k", "4", "--pops_path", "LABELS"],
     "requires --k"),
    (["--k", "3", "--pops_path", "SHORT"], "labels but the data has"),
    (["--k", "3", "--pops_path", "LABELS"], "not equal to the value of K"),
    (["--min_k", "1", "--max_k", "4"], "min_k must be greater than 1"),
    (["--min_k", "4", "--max_k", "4"], "max_k must be greater than min_k"),
])
def test_cli_bad_k_and_labels_raise(tmp_path, extra, error):
    (tmp_path / "LABELS").write_text("\n".join(["A", "B"] * 52 + ["A"]))
    (tmp_path / "SHORT").write_text("A\nB\nC\n")
    extra = [str(tmp_path / a) if a in ("LABELS", "SHORT") else a
             for a in extra]
    argv = ["train", "--data_path", DEMO_BED, "--save_dir",
            str(tmp_path / "out"), "--name", "m", "--num_gpus", "0"]
    with pytest.raises(ValueError, match=error):
        tentry.main(argv + extra)
    assert not (tmp_path / "out").exists()
