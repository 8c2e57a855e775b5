"""``--init_restarts`` and ``--profile_dir`` in the port, on the CPU.

  * restarts (the JAX package's train/run.py:217-283): run r draws its GMM
    init and its trainer from ``seed + r`` and V from ``--seed`` (spies),
    one PCA projection serves every run; the written .Q/.P are byte for
    byte those of the best run rebuilt by hand from the library (V from
    ``--seed``, the GMM and the trainer from ``seed + r``), the first kept on
    a tie; LL(R = 3) >= LL(R = 1) (tests/test_cli.py:70's property);
    ``--checkpoint_every`` writes ``_r{r}`` files and ``--resume`` finishes
    each run from its own; on a ``--mesh 2x1`` grid of CPU ranks every rank
    keeps the same run, which equals that run rebuilt on the grid;
  * the trace: one Chrome JSON file with one ``epoch N`` span an epoch,
    parameters bit-equal to an untraced run's, the file written and the
    profiler stopped on SIGTERM's exit 143 and on an exception, one file per
    rank on a grid; on the card (``cuda`` marker) the kernels K2-K5 appear
    in the trace as often as their wrappers count launches.

Nothing here imports JAX, so on the card ``python -m pytest --noconftest -m
cuda tests/test_torch_port_restarts.py`` runs where JAX is not installed.
"""
import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.io.bed import read_bed_packed
from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.io.writers import write_outputs
from neural_admixture_tpu_torch.ops.loglikelihood import loglikelihood_packed
from neural_admixture_tpu_torch.ops.rsvd import rsvd
from neural_admixture_tpu_torch.parallel import distributed as tdist
from neural_admixture_tpu_torch.train import init as tinit
from neural_admixture_tpu_torch.train import run as trun
from neural_admixture_tpu_torch.train.engine import (
    NeuralAdmixtureTrainer, TrainConfig, block_geometry, epoch_plan)
from neural_admixture_tpu_torch.train.init import (init_p_unsupervised,
                                                   pca_coords)
from neural_admixture_tpu_torch.utils.seeding import generator
from neural_admixture_tpu_torch.utils.trace import (busy_share, epoch_spans,
                                                    kernel_counts,
                                                    load_events)

DEMO_BED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demo", "data", "demo_data.bed")
SEED, EPOCHS, BATCH, HIDDEN, K = 11, 2, 64, 32, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _argv(out_dir, name, restarts, *extra):
    return ["train", "--k", str(K), "--data_path", DEMO_BED, "--save_dir",
            str(out_dir), "--name", name, "--epochs", str(EPOCHS), "--seed",
            str(SEED), "--batch_size", str(BATCH), "--hidden_size",
            str(HIDDEN), "--num_gpus", "0", "--no_progress",
            "--init_restarts", str(restarts), *extra]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_outputs(dir_a, name_a, dir_b, name_b):
    return all(_bytes(os.path.join(dir_a, f"{name_a}.{K}.{m}"))
               == _bytes(os.path.join(dir_b, f"{name_b}.{K}.{m}"))
               for m in ("Q", "P"))


@pytest.fixture(scope="module")
def restarts(tmp_path_factory):
    """Three restarts rebuilt by hand from the library, written as
    ``hand{r}``, with their log-likelihoods; the CLI's R = 1 and R = 3 runs,
    the latter under spies on the GMM seeds, the trainer seeds and the PCA
    projection."""
    d = tmp_path_factory.mktemp("restarts")
    torch.set_num_threads(1)  # the CLI's --threads 1: the same sum orders
    packed, N, M = read_bed_packed(DEMO_BED)
    V = rsvd(packed, N, M, 8, SEED, device="cpu")
    x_pca = pca_coords(packed, V, N, device="cpu")
    lls = []
    for r in range(3):
        P_init = init_p_unsupervised(None, V, N, M, [K], SEED + r,
                                     x_pca=x_pca)
        Qs, Ps, _ = NeuralAdmixtureTrainer(TrainConfig(
            epochs=EPOCHS, batch_size=BATCH, seed=SEED + r,
            hidden_size=HIDDEN, n_components=8, ks=[K], progress=False,
            sample_block=16, device="cpu")).launch_training(
                P_init, packed, V, M, N)
        write_outputs(Qs, f"hand{r}", K, None, None, str(d), Ps)
        lls.append(loglikelihood_packed(packed, M, Ps[0].astype(np.float64),
                                        Qs[0].astype(np.float64)))
    assert tentry.main(_argv(d, "one", 1)) == 0
    spied = {"gmm": [], "trainer": [], "projections": 0}
    real_init, real_launch = trun.init_p_unsupervised, \
        NeuralAdmixtureTrainer.launch_training
    real_project = tinit.project_pca

    def gmm(*a, **kw):
        spied["gmm"].append(a[5])
        return real_init(*a, **kw)

    def launch(trainer, *a, **kw):
        spied["trainer"].append(trainer.cfg.seed)
        return real_launch(trainer, *a, **kw)

    def project(*a, **kw):
        spied["projections"] += 1
        return real_project(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trun, "init_p_unsupervised", gmm)
        mp.setattr(NeuralAdmixtureTrainer, "launch_training", launch)
        mp.setattr(tinit, "project_pca", project)
        assert tentry.main(_argv(d, "three", 3)) == 0
    return d, lls, spied, packed, M


def test_restarts_draw_seed_plus_r_and_project_once(restarts):
    _, _, spied, _, _ = restarts
    assert spied["gmm"] == [SEED, SEED + 1, SEED + 2]
    assert spied["trainer"] == [SEED, SEED + 1, SEED + 2]
    assert spied["projections"] == 1


def test_restarts_write_the_best_run_rebuilt_by_hand(restarts):
    """The kept run is the largest log-likelihood's, the first on a tie;
    its files are those of the run rebuilt by hand, byte for byte, and R =
    1 writes restart 0's."""
    d, lls, _, _, _ = restarts
    best = int(np.argmax(lls))  # the first of equal maxima
    assert _same_outputs(d, "three", d, f"hand{best}")
    assert _same_outputs(d, "one", d, "hand0")


def test_restarts_never_lose_to_one_run(restarts):
    """tests/test_cli.py:70's property: LL(R = 3) >= LL(R = 1)."""
    d, _, _, packed, M = restarts

    def ll(name):
        Q = np.loadtxt(os.path.join(d, f"{name}.{K}.Q"))
        P = np.loadtxt(os.path.join(d, f"{name}.{K}.P"))
        return loglikelihood_packed(packed, M, P, Q)

    assert ll("three") >= ll("one") - 1e-6


def test_restarts_keep_the_first_on_a_tie(restarts, monkeypatch, tmp_path):
    """Every run scores the same: the first is kept (a strict '>')."""
    d, _, _, _, _ = restarts
    monkeypatch.setattr(trun, "loglikelihood_packed", lambda *a, **kw: 0.0)
    assert tentry.main(_argv(tmp_path, "tie", 2)) == 0
    assert _same_outputs(tmp_path, "tie", d, "hand0")


def test_restarts_checkpoint_and_resume_each_run(restarts, tmp_path,
                                                 caplog):
    """With --checkpoint_every, run r writes NAME_ckpt_r{r}.npz (its meta
    holds seed + r); --resume continues each run from its own file, and
    the two runs of 1 + 1 epochs write what two uninterrupted 2-epoch runs
    write: the better of restarts 0 and 1 rebuilt by hand."""
    d, lls, _, _, _ = restarts
    argv = _argv(tmp_path, "ck", 2, "--checkpoint_every", "1")
    argv[argv.index("--epochs") + 1] = "1"
    assert tentry.main(argv) == 0
    names = sorted(p.name for p in tmp_path.glob("ck_ckpt*"))
    assert names == ["ck_ckpt_r0.npz", "ck_ckpt_r1.npz"]
    for r in range(2):
        with np.load(tmp_path / f"ck_ckpt_r{r}.npz") as f:
            assert int(f["epoch"]) == 1
            assert json.loads(bytes(f["meta"]).decode())["seed"] == SEED + r
    caplog.set_level(logging.INFO)
    argv[argv.index("--epochs") + 1] = str(EPOCHS)
    assert tentry.main(argv + ["--resume"]) == 0
    resumed = [r.getMessage() for r in caplog.records
               if "Resuming from epoch" in r.getMessage()]
    assert resumed == ["    Resuming from epoch 1."] * 2
    assert _same_outputs(tmp_path, "ck", d, f"hand{int(np.argmax(lls[:2]))}")


def _restart_rebuilt_rank(grid, args, stream, N, M, t0, r):
    """A grid's run of restart r alone: V from --seed, the GMM and the
    trainer from seed + r (one rank of a spawned grid)."""
    seed, real_rsvd = int(args.seed), trun.rsvd
    trun.rsvd = lambda packed, n, m, k, _seed, **kw: real_rsvd(
        packed, n, m, k, seed, **kw)
    args.seed = seed + r
    return trun._train_rank(grid, args, stream, N, M, t0)


def test_restarts_on_a_2x1_grid_of_cpu_ranks(tmp_path):
    """Every rank keeps the same run; the files are those of that run
    rebuilt alone on the grid; the trace is one file per rank and run."""
    N, M = trun.input_dims(DEMO_BED)
    traces = tmp_path / "trace"
    args = tentry.parse_train_args(_argv(tmp_path, "grid", 2,
                                         "--mesh", "2x1", "--profile_dir",
                                         str(traces))[1:])
    ranks = tdist.spawn_grid(trun._train_rank, 2, 1,
                             args=(args, None, N, M, time.time()),
                             init_method=f"file://{tmp_path}/rdv1")
    assert ranks[0] == ranks[1]
    r = ranks[0][0]
    assert sorted(p.name for p in traces.iterdir()) == [
        "epochs_rank0.json", "epochs_rank0_1.json", "epochs_rank1.json",
        "epochs_rank1_1.json"]
    rebuilt = tentry.parse_train_args(_argv(tmp_path, "rebuilt", 1,
                                            "--mesh", "2x1")[1:])
    again = tdist.spawn_grid(_restart_rebuilt_rank, 2, 1,
                             args=(rebuilt, None, N, M, time.time(), r),
                             init_method=f"file://{tmp_path}/rdv2")
    assert again[0][1] == ranks[0][1]  # the same log-likelihoods
    assert _same_outputs(tmp_path, "grid", tmp_path, "rebuilt")


def _data(seed=3, n=61, m=700, k=3, d=4):
    rng = np.random.default_rng(seed)
    packed, _ = pack_with_padding(
        rng.integers(0, 4, size=(n, m)).astype(np.uint8))
    V = (rng.normal(size=(d, m)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(k, m)).astype(np.float32)
    return packed, V, P0


def _train(device="cpu", epochs=3, plans=None, **kw):
    packed, V, P0 = _data()
    trainer = NeuralAdmixtureTrainer(TrainConfig(
        epochs=epochs, batch_size=24, seed=5, hidden_size=16,
        n_components=4, ks=[3], progress=False, sample_block=8,
        device=str(device), **kw))
    drawn = None
    if plans is not None:
        n_rows = block_geometry(61, 24, 8)[3]

        def drawn(epoch):  # the trainer's own plans, after plans()
            plans(trainer, epoch)
            return epoch_plan(generator(5, 1, epoch), 61, 24, 8, n_rows)
    return trainer, trainer.launch_training(P0, packed, V, 700, 61,
                                            plans=drawn)


def _spans(path):
    return [name for name, _, _ in epoch_spans(load_events(path))]


def test_trace_spans_each_epoch_and_changes_no_number(tmp_path):
    _, (Qa, Pa, pa) = _train()
    _, (Qb, Pb, pb) = _train(profile_dir=str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == ["epochs_rank0.json"]
    assert _spans(tmp_path / "epochs_rank0.json") == [
        "epoch 0", "epoch 1", "epoch 2"]
    np.testing.assert_array_equal(Qa[0], Qb[0])
    np.testing.assert_array_equal(Pa[0], Pb[0])
    flat_a, flat_b = _flatten(pa), _flatten(pb)
    assert flat_a.keys() == flat_b.keys()
    for name in flat_a:
        np.testing.assert_array_equal(flat_a[name], flat_b[name], name)


def _flatten(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


class _Stop(RuntimeError):
    pass


@pytest.mark.parametrize("how", ["sigterm", "exception"])
def test_trace_is_written_and_stopped_on_every_way_out(tmp_path, how):
    """SIGTERM (the handler's flag, raised while epoch 1's plan is drawn)
    saves at the end of epoch 1 and exits 143; an exception raised there
    ends the loop. Either way the trace holds what ran and no profiler is
    left running."""
    def at_epoch_1(trainer, epoch):
        if epoch == 1:
            if how == "exception":
                raise _Stop("stop in epoch 1")
            trainer._preempted = True

    trace = tmp_path / "trace"
    kw = dict(profile_dir=str(trace), plans=at_epoch_1)
    if how == "sigterm":
        with pytest.raises(SystemExit) as exc:
            _train(checkpoint_every=5,
                   checkpoint_path=str(tmp_path / "ck.npz"), **kw)
        assert exc.value.code == 143
        assert (tmp_path / "ck.npz").exists()
        spans = ["epoch 0", "epoch 1"]
    else:
        with pytest.raises(_Stop):
            _train(**kw)
        spans = ["epoch 0", "epoch 1"]
    assert not torch.autograd._profiler_enabled()
    assert _spans(trace / "epochs_rank0.json") == spans


@pytest.mark.cuda
def test_trace_counts_the_kernels_on_card(cuda_device, tmp_path):
    """On the card the trace holds K2-K5 as often as their wrappers count
    launches in the epochs, and a busy device inside each epoch span."""
    from neural_admixture_tpu_torch.ops.dq_dp import dq_dp
    from neural_admixture_tpu_torch.ops.dv import dv
    from neural_admixture_tpu_torch.ops.xv import xv
    wrappers = {"xv": (xv, "launches"), "dq_dp": (dq_dp, "launches"),
                "loss_dq_dp": (dq_dp, "loss_launches"),
                "dv": (dv, "launches")}
    for fn, attr in wrappers.values():
        setattr(fn, attr, 0)
    _, (Q, _, _) = _train(cuda_device, profile_dir=str(tmp_path))
    counts = {n: getattr(fn, attr) for n, (fn, attr) in wrappers.items()}
    events = load_events(tmp_path / "epochs_rank0.json")
    traced = kernel_counts(events)
    assert traced.pop("bce_sum") == 0
    # The Q pass after the epochs runs xv once a 1024-row block.
    counts["xv"] -= -(-Q[0].shape[0] // 1024)
    assert traced == counts
    for _, start, end in epoch_spans(events):
        assert 0 < busy_share(events, start, end) <= 1
