"""The port's spans and set-up counters.

  * a ``--profile_dir`` trace holds, inside each ``epoch N``, ``na.plan``,
    then per step ``na.batch``, ``na.forward``, ``na.backward``,
    ``na.adam``, ``na.clamp``, then ``na.epoch_end``, none nested in
    another, and the traced run's Q, P and parameters equal an untraced
    run's bit for bit; a streamed run and a supervised run hold the same
    spans;
  * with no profiler recording, ``span`` enters no ``record_function``;
    a span open across the profiler's stop closes without error;
  * ``phase_seconds``' ``layout.host`` and ``layout.upload`` tile
    ``layout``, and ``init.params`` and ``init.optimizer`` tile ``init``
    (a resumed checkpoint's load inside ``init.params``);
  * on the card (``cuda`` marker): the same spans, resident and streamed,
    the run equal to an untraced one.

Nothing here imports JAX, so on the card ``python -m pytest --noconftest -m
cuda tests/test_torch_port_spans.py`` runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from neural_admixture_tpu_torch.io.packed import pack_with_padding
from neural_admixture_tpu_torch.train.engine import (NeuralAdmixtureTrainer,
                                                     TrainConfig,
                                                     block_geometry)
from neural_admixture_tpu_torch.utils import trace as port_trace
from neural_admixture_tpu_torch.utils.trace import (epoch_spans, load_events,
                                                    span)

N, M, K, D, B, BLK, EPOCHS = 61, 700, 3, 4, 24, 8, 3
STEP = ["na.batch", "na.forward", "na.backward", "na.adam", "na.clamp"]


def _data(seed=3):
    rng = np.random.default_rng(seed)
    packed, _ = pack_with_padding(
        rng.integers(0, 4, size=(N, M)).astype(np.uint8))
    V = (rng.normal(size=(D, M)) * 0.1).astype(np.float32)
    P0 = rng.uniform(0.2, 0.8, size=(K, M)).astype(np.float32)
    return packed, V, P0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _train(epochs=EPOCHS, pops=None, device="cpu", **kw):
    packed, V, P0 = _data()
    trainer = NeuralAdmixtureTrainer(TrainConfig(
        epochs=epochs, batch_size=B, seed=5, hidden_size=16, n_components=D,
        ks=[K], progress=False, sample_block=BLK, device=str(device), **kw))
    return trainer, trainer.launch_training(P0, packed, V, M, N, pops=pops)


def _na_spans(path):
    """(name, start, end) of every ``na.*`` span, in order of start."""
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in load_events(path)
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(port_trace.SPAN_PREFIX)),
                  key=lambda s: s[1])


def _steps_per_epoch():
    return block_geometry(N, B, BLK)[1]


def _check_epochs(path):
    """Each epoch's spans in order, flat, inside its ``epoch N``."""
    spans = _na_spans(path)
    want = ["na.plan"] + STEP * _steps_per_epoch() + ["na.epoch_end"]
    assert [n for n, _, _ in spans] == want * EPOCHS
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start  # no span nests in or overlaps another
    epochs = epoch_spans(load_events(path))
    assert [n for n, _, _ in epochs] == [f"epoch {e}" for e in range(EPOCHS)]
    for e, (_, a, b) in enumerate(epochs):
        inside = spans[e * len(want):(e + 1) * len(want)]
        assert all(a <= s and t <= b for _, s, t in inside)


def _flatten(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def _assert_same_run(a, b):
    (Qa, Pa, pa), (Qb, Pb, pb) = a, b
    np.testing.assert_array_equal(Qa[0], Qb[0])
    np.testing.assert_array_equal(Pa[0], Pb[0])
    flat_a, flat_b = _flatten(pa), _flatten(pb)
    assert flat_a.keys() == flat_b.keys()
    for name in flat_a:
        np.testing.assert_array_equal(flat_a[name], flat_b[name], name)


def test_profile_dir_spans_tile_each_epoch_and_change_no_number(tmp_path):
    _, plain = _train()
    _, traced = _train(profile_dir=str(tmp_path))
    _check_epochs(tmp_path / "epochs_rank0.json")
    _assert_same_run(plain, traced)


@pytest.mark.parametrize("how", ["streamed", "supervised"])
def test_other_paths_hold_the_same_spans(tmp_path, how):
    kw = dict(stream=True) if how == "streamed" else dict(
        pops=np.arange(N) % K)
    trainer, traced = _train(profile_dir=str(tmp_path), **kw)
    assert trainer._streamed == (how == "streamed")
    _check_epochs(tmp_path / "epochs_rank0.json")
    _, plain = _train(**kw)
    _assert_same_run(plain, traced)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
def test_the_card_holds_the_same_spans(cuda_device, tmp_path, stream):
    trainer, traced = _train(profile_dir=str(tmp_path), device=cuda_device,
                             stream=stream)
    assert trainer._streamed == stream
    _check_epochs(tmp_path / "epochs_rank0.json")
    _, plain = _train(device=cuda_device, stream=stream)
    _assert_same_run(plain, traced)


class _Entered(AssertionError):
    pass


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise _Entered(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    off = span("forward")
    assert span("adam") is off
    with off:
        pass
    _train(epochs=2)  # every span of the loop, none entered


def test_a_span_open_across_the_profilers_stop_closes(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    s = span("plan")
    s.__enter__()
    with span("batch"):
        torch.ones(3).add_(1)
    prof.stop()
    s.__exit__(None, None, None)
    assert not torch.autograd._profiler_enabled()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert [n for n, _, _ in _na_spans(tmp_path / "t.json")] == [
        "na.plan", "na.batch"]


def _tiles(phase, parent, children):
    assert set(children) <= set(phase)
    assert sum(phase[c] for c in children) == pytest.approx(
        phase[parent], rel=1e-9, abs=1e-9)
    assert all(phase[c] >= 0 for c in children)


@pytest.mark.parametrize("stream", [False, True])
def test_phase_counters_tile_layout_and_init(stream):
    trainer, _ = _train(epochs=1, stream=stream)
    phase = trainer.phase_seconds
    if stream:
        assert "layout.upload" not in phase
        _tiles(phase, "layout", ["layout.host"])
    else:
        _tiles(phase, "layout", ["layout.host", "layout.upload"])
    _tiles(phase, "init", ["init.params", "init.optimizer"])


def test_a_resumed_load_counts_in_init_params(tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    _train(epochs=2, checkpoint_every=1, checkpoint_path=ckpt)
    trainer, _ = _train(epochs=EPOCHS, checkpoint_every=1,
                        checkpoint_path=ckpt, resume=True)
    phase = trainer.phase_seconds
    _tiles(phase, "init", ["init.params", "init.optimizer"])
    assert 0 < phase["load"] <= phase["init.params"]
