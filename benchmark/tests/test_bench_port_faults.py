"""A whole run of the harness at a tiny size on the CPU (the look for a
chip skipped): sound, it comes out correct; with the timed path broken
underneath, once for each fault a training cell on one chip can have, it
comes out not correct."""
import numpy as np
import pytest
import torch

from benchmark import harness

from ._tiny import tiny_cell


def _run(seed=2**31 + 101):
    return harness.run(tiny_cell(), seed, 0.2, False, torch.device("cpu"),
                       0.0, ref_chunk=1024)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert res["device"]["platform"] == "cpu"


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from neural_admixture_tpu_torch.train import engine
    real = engine.fused_training_loss

    def half(model, packed, col_mask, row_w, *args, **kw):
        h = packed.shape[0] // 2
        loss, qs = real(model, packed[:h], col_mask, row_w[:h], *args, **kw)
        return loss * 2, qs
    monkeypatch.setattr(engine, "fused_training_loss", half)


def _answer_altered(monkeypatch):
    from neural_admixture_tpu_torch.train import engine
    real = engine.chunked_forward

    def altered(*args, **kw):
        out = real(*args, **kw)
        hk = next(iter(out))
        out[hk][5] = np.roll(out[hk][5], 1)
        return out
    monkeypatch.setattr(engine, "chunked_forward", altered)


def _state_frozen_in_the_window(monkeypatch):
    """Every optimizer's steps past its sixth (the tiny cell's epoch 0 has
    five) return the state unchanged: the first steps are sound."""
    real = torch.optim.Adam.step

    def step(self, closure=None):
        self._bench_steps = getattr(self, "_bench_steps", 0) + 1
        return real(self, closure) if self._bench_steps <= 6 else None
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _half_batch_unlogged(monkeypatch):
    """Half of each unlogged batch (the plane pass's K3 steps) left out,
    the loss scaled to the whole batch; logged steps are sound."""
    from neural_admixture_tpu_torch.train import engine
    real = engine.fused_training_loss

    def half(model, packed, col_mask, row_w, masked, no_missing, logged,
             *args, **kw):
        if logged:
            return real(model, packed, col_mask, row_w, masked, no_missing,
                        logged, *args, **kw)
        h = packed.shape[0] // 2
        loss, qs = real(model, packed[:h], col_mask, row_w[:h], masked,
                        no_missing, logged, *args, **kw)
        return loss * 2, qs
    monkeypatch.setattr(engine, "fused_training_loss", half)


def _remainder_unmasked(monkeypatch):
    """The remainder batch's padding rows counted as real rows."""
    from neural_admixture_tpu_torch.train import engine
    real = engine.fused_training_loss

    def unmasked(model, packed, col_mask, row_w, *args, **kw):
        return real(model, packed, col_mask, torch.ones_like(row_w), *args,
                    **kw)
    monkeypatch.setattr(engine, "fused_training_loss", unmasked)


def _returned_params_altered(monkeypatch):
    from neural_admixture_tpu_torch.train import engine
    real = engine.to_host

    def altered(*args, **kw):
        out = real(*args, **kw)
        out["V"] = out["V"].copy()
        out["V"][0, 0] += 1e-3
        return out
    monkeypatch.setattr(engine, "to_host", altered)


@pytest.mark.parametrize("fault, caught_by", [
    (_state_unchanged, "loss_gap"),
    (_half_batch, "loss_gap"),
    (_answer_altered, "q_gap"),
    (_state_frozen_in_the_window, "win_change_gap"),
    (_half_batch_unlogged, "win_grad_gap"),
    (_remainder_unmasked, "win_grad_gap"),
    (_returned_params_altered, "params_differ"),
])
def test_a_broken_step_is_not_correct(monkeypatch, fault, caught_by):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"]
    check = res["checks"][caught_by]
    assert not check["value"] <= check["limit"], res["checks"]
