"""One run of one cell: set-up, the measured window, the output check.

The window drives the port's training entry,
``NeuralAdmixtureTrainer.launch_training``, resident on one device, over
5 W + 1 epochs of the cell's panel, batch and heads:

  set-up   the panel simulated on the device and copied to host memory
           (launch_training takes host rows); the parameters and every
           epoch's plan from the seed; a warm-up call on a slice of the
           panel (two full batches and the remainder, six epochs: every
           kernel instance, logged and unlogged, and the first Adam), whose
           epoch times fix W; then the measured call's layout, init and
           epoch 0, whose first steps are read for the check.
  window   from the measured call's request for epoch 1's plan to its
           return, both after a synchronise, less the call's own
           ``phase_seconds["results"]`` (the parameters to host memory and
           the host's Fst tables: host work whose time varies two- to
           three-fold from one machine to another): 5 W epochs (W whole log
           periods, epochs 5, 10, ... logged) and the Q pass.
  check    after the window, the plain reference (reference.py) follows
           the first three steps from the same parameters and rows; replays
           four steps of the window from the program's state copied just
           before each (:data:`WINDOW_STEPS`); holds the returned parameters
           to the trained state; and recomputes every Q from them.

With ``trace`` a torch.profiler trace covers the window's epochs 1 to 6;
epochs 2 to 6, one whole log period, are read (``period``).
"""
import dataclasses
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import plans as plan_maker
from . import reference, sim, spec
from . import trace as trace_reader

BANNED_MODULES = ("jax", "jaxlib", "flax", "neural_admixture_tpu")
PERIOD_BEGIN, PERIOD_END = "benchmark.period.begin", "benchmark.period.end"
WARM_EPOCHS = 6
TRACE_FIRST = 2  # the traced period: epochs 2 .. 2 + log_every - 1
CHECK_STEPS = 3
# The window's steps the check replays, as (epoch, batch) with epoch -1 the
# last and batch -1 the remainder: epoch 1's first (K3, unlogged) and its
# remainder (K3, masked), the last epoch's first (K4, logged) and its
# remainder (K4, masked; the run's last step).
WINDOW_STEPS = ((1, 0), (1, -1), (-1, 0), (-1, -1))


def banned_modules(modules) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is that of
    JAX or of the JAX package, compared whole."""
    return sorted(m for m in modules
                  if m.split(".")[0] in BANNED_MODULES)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """What the metric readers read (end_to_end/*.py, metrics/*.py)."""
    samples: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    phase: Dict[str, float] = field(default_factory=dict)
    warm_phase: Dict[str, float] = field(default_factory=dict)
    events: List[Dict] = field(default_factory=list)
    period: Tuple[float, float] = (0.0, 0.0)
    period_steps: List[Tuple[int, bool]] = field(default_factory=list)
    M: int = 0
    D: int = 0
    ks: List[int] = field(default_factory=list)


# The port's parameter names -> the layout's, and whether it is transposed.
def layout_name(name: str, ks: List[int]) -> Tuple[str, bool]:
    parts = name.split(".")
    if name == "V":
        return "V", False
    if name == "batch_norm.weight":
        return "rmsnorm/weight", False
    if parts[0] == "common_encoder":
        return f"common/{'kernel' if parts[2] == 'weight' else 'bias'}", \
            parts[2] == "weight"
    if parts[0] == "multihead_encoder":
        hk = f"k{ks[int(parts[2])]}"
        return (f"heads/{hk}/{'kernel' if parts[3] == 'weight' else 'bias'}",
                parts[3] == "weight")
    if parts[0] == "decoders":
        return f"decoders/{parts[1]}", False
    raise KeyError(f"unknown parameter {name}")


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.detach().double())


def _floats(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in d.items()}


class Steps:
    """Reads the program's steps as they run, through its epoch loop's step
    and the optimizer's state (Adam's exp_avg, exp_avg_sq and step):

      first    steps 0 .. n - 1 from the initial weights: each step's loss,
               step 1's gradient per leaf (exp_avg after step 1 is
               (1 - beta1) g), and each leaf's change after step n (read as
               step n + 1 starts, after step n's P clamp);
      window   each step of ``targets``: before it, a copy of every leaf
               with its Adam moments and step count; its loss where it is
               logged, and each leaf's gradient as the step hands it to the
               optimizer (``.grad``: deep in a run exp_avg may carry an
               earlier step's gradient at 1e11, and m_t - beta1 m_t-1 then
               cancels to noise); after it (as the next step starts, or as
               the loop returns), each leaf's change;
      final    the trained parameters themselves (held, not copied), to be
               held against what the call returns.

    Norms stay device scalars, read once the window has closed."""

    def __init__(self, n: int, beta1: float, p0: Dict[str, torch.Tensor],
                 targets=()):
        self.n, self.beta1, self.p0 = n, beta1, p0
        self.targets = set(targets)
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}
        self.window: Dict[int, Dict] = {}
        self.final: Dict[str, Tuple[torch.Tensor, bool]] = {}
        self.calls = 0
        self._named: List = []
        self._opt = None
        self._open: Optional[int] = None

    def wrap(self, model, opt, step_fn: Callable) -> Callable:
        self._named = [(layout_name(name, list(model.ks)), p)
                       for name, p in model.named_parameters()]
        self._opt = opt

        def step(*args):
            i = self.calls
            self.calls += 1
            self._after()
            if i == 1:
                self.grad = {
                    nm: _norm(opt.state[p]["exp_avg"]) / (1 - self.beta1)
                    for (nm, _), p in self._named if p in opt.state}
            if i == self.n:
                self.change = {
                    nm: _norm(p - (self.p0[nm].T if tr else self.p0[nm]))
                    for (nm, tr), p in self._named}
                self.p0 = {}
            if i in self.targets:
                self._before(i)
            loss = step_fn(*args)
            if i < self.n:
                self.losses.append(loss.detach())
            if i in self.window:
                w = self.window[i]
                if args[4]:  # step_fn(..., logged)
                    w["loss"] = loss.detach()
                w["grad"] = {nm: _norm(p.grad) for (nm, _), p in self._named
                             if p.grad is not None}
            return loss
        return step

    def _before(self, i: int) -> None:
        state = self._opt.state

        def moment(p, key):
            return state[p][key].clone() if p in state else None
        steps = [state[p]["step"] for _, p in self._named if p in state]
        self.window[i] = {
            "adam_step": int(steps[0]) if steps else 0, "loss": None,
            "state": {nm: (tr, p.detach().clone(), moment(p, "exp_avg"),
                           moment(p, "exp_avg_sq"))
                      for (nm, tr), p in self._named}}
        self._open = i

    def _after(self) -> None:
        if self._open is None:
            return
        w = self.window[self._open]
        self._open = None
        w["change"] = {nm: _norm(p - w["state"][nm][1])
                       for (nm, _), p in self._named}

    def finish(self) -> None:
        """The loop has returned: the last step's after-state, and the
        trained parameters."""
        self._after()
        self.final = {nm: (p.detach(), tr) for (nm, tr), p in self._named}

    def numbers(self) -> Dict:
        return {"loss": [float(x) for x in self.losses],
                "grad": _floats(self.grad), "change": _floats(self.change)}

    def window_numbers(self, i: int) -> Optional[Dict]:
        """Step ``i``'s numbers as :meth:`numbers` gives the first steps'
        (its loss only where logged), or None if it never ran."""
        w = self.window.get(i)
        if w is None or "change" not in w:
            return None
        return {"loss": [] if w["loss"] is None else [float(w["loss"])],
                "grad": _floats(w["grad"]), "change": _floats(w["change"])}

    def window_state(self, i: int) -> Optional[Tuple[Dict, int]]:
        """{leaf: (parameter, exp_avg, exp_avg_sq)} before step ``i``, in
        the layout's orientation, and Adam's step count; None if the
        optimizer held no state."""
        w = self.window.get(i)
        if w is None or any(m is None for _, _, m, _ in w["state"].values()):
            return None

        def orient(t, tr):
            return t.T if tr else t
        return {nm: tuple(orient(t, tr) for t in (p, m, v))
                for nm, (tr, p, m, v) in w["state"].items()}, w["adam_step"]


def observed_trainer(watch: Steps):
    """The port's trainer, its epoch loop's step wrapped by ``watch``."""
    from neural_admixture_tpu_torch.train.engine import NeuralAdmixtureTrainer

    class Observed(NeuralAdmixtureTrainer):
        def _run_epochs(self, model, opt, start_epoch, steps, step_fn,
                        *args):
            out = super()._run_epochs(model, opt, start_epoch, steps,
                                      watch.wrap(model, opt, step_fn),
                                      *args)
            watch.finish()
            return out
    return Observed


class Window:
    """The measured call's ``plans``: it hands out each epoch's plan and,
    at epoch 1's request, opens the window; with ``trace`` it profiles
    epochs 1 to TRACE_FIRST + log_every - 1 and marks the period read."""

    def __init__(self, plans, device, trace: bool, log_every: int):
        self.plans, self.device, self.trace = plans, device, trace
        self.first, self.last = TRACE_FIRST, TRACE_FIRST + log_every
        self.t_open: Optional[float] = None
        self.prof = None
        self.trace_dir: Optional[str] = None

    def __call__(self, epoch: int):
        if epoch == 1:
            sync(self.device)
            self.t_open = time.perf_counter()
            if self.trace:
                self._start()
        if self.prof is not None and epoch == self.first:
            with torch.profiler.record_function(PERIOD_BEGIN):
                pass
        if self.prof is not None and epoch == self.last:
            with torch.profiler.record_function(PERIOD_END):
                pass
            self._stop()
        return self.plans[epoch]

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def _stop(self) -> None:
        self.prof.stop()
        self.trace_dir = tempfile.mkdtemp(prefix="benchmark_trace_")
        self.prof.export_chrome_trace(os.path.join(self.trace_dir,
                                                   "trace.json"))
        self.prof = None

    def events(self) -> List[Dict]:
        if self.trace_dir is None:
            return []
        try:
            return trace_reader.load_events(
                os.path.join(self.trace_dir, "trace.json"))
        finally:
            shutil.rmtree(self.trace_dir, ignore_errors=True)


def train_config(cell: spec.Cell, epochs: int, seed: int, device):
    """The port's TrainConfig: every key of the configuration's file that
    names one of its fields, then the cell's ``train_options`` (such as
    ``stream``), then the run's epochs, seed and device, progress off."""
    from neural_admixture_tpu_torch.train.engine import TrainConfig
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in cell.config.items() if k in names}
    kw.update(cell.workload.get("train_options", {}))
    kw.update(epochs=int(epochs), seed=int(seed), device=str(device),
              progress=False)
    return TrainConfig(**kw)


def log_periods(epoch_seconds: List[float], rows_ratio: float,
                seconds: float, log_every: int) -> Tuple[int, float]:
    """(W, the estimated seconds of one log period) from the warm-up's
    epochs: epoch 0 logged (cold), 1 .. log_every - 1 unlogged, log_every
    logged, scaled by the measured call's rows over the warm-up's."""
    t_unlogged = statistics.median(epoch_seconds[1:log_every])
    t_logged = epoch_seconds[log_every]
    period = (t_logged + (log_every - 1) * t_unlogged) * rows_ratio
    return max(1, int(round(seconds / period))), period


def leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Per leaf, the gap between the program's and the reference's norm
    (step 1's gradient: "grad"; the change over the steps: "change"),
    against the larger of the reference's norm of that leaf and of the
    median leaf. Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out of the
    change. A leaf the program did not give reads inf."""
    inf = float("inf")
    g_med = statistics.median(ref["grad"].values())
    moved = [k for k, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in moved)
    return {
        "grad": {k: abs(prog["grad"].get(k, inf) - r) / max(r, g_med)
                 for k, r in ref["grad"].items()},
        "change": {k: abs(prog["change"].get(k, inf) - ref["change"][k])
                   / max(ref["change"][k], c_med) for k in moved}}


def check_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of a run of steps: loss_gap, the largest relative gap of
    a step's loss (0 where neither side gives one); grad_gap, the worst
    leaf's gap of the first step's gradient; change_gap and
    change_gap_median, the worst and the median leaf's gap of the change
    over the steps (:func:`leaf_gaps`). A number the program did not give
    reads inf.

    The worst leaf's change swings from seed to seed over the first steps:
    a first gradient at rounding level takes Adam's full first step with
    either sign, and a V element so flipped moves every row's Xp and with
    it the later steps of every leaf downstream. The median leaf's change
    carries the same flips and holds still (PERF.md, section 6)."""
    inf = float("inf")
    out = {"loss_gap": inf}
    if len(prog["loss"]) == len(ref["loss"]):
        out["loss_gap"] = max((abs(p - r) / abs(r) for p, r in
                               zip(prog["loss"], ref["loss"])), default=0.0)
    gaps = leaf_gaps(prog, ref)
    out["grad_gap"] = max(gaps["grad"].values())
    out["change_gap"] = max(gaps["change"].values())
    out["change_gap_median"] = statistics.median(gaps["change"].values())
    return {k: (v if np.isfinite(v) else inf) for k, v in out.items()}


def window_steps(nb: int, epochs: int) -> List[Tuple[int, int, int]]:
    """(step of the call, epoch, batch) of each of :data:`WINDOW_STEPS` in
    a call of ``epochs`` epochs of ``nb`` steps."""
    out = []
    for e, j in WINDOW_STEPS:
        e, j = e % epochs, j % nb
        out.append((e * nb + j, e, j))
    return out


def params_differ(params: Dict, final: Dict[str, Tuple[torch.Tensor, bool]]
                  ) -> float:
    """Elements of the returned parameter dict that differ from the
    trained state (every element of a leaf that is missing or misshapen;
    inf if the state was never read)."""
    if not final:
        return float("inf")
    returned = reference.flatten(params)
    bad = 0
    for nm, (p, tr) in final.items():
        mine = (p.T if tr else p).detach().cpu().numpy()
        got = np.asarray(returned.get(nm, np.empty(0)))
        bad += (int(np.count_nonzero(got != mine))
                if got.shape == mine.shape else mine.size)
    return float(bad + len(set(returned) - set(final)))


def worst_leaves(prog: Dict, ref: Dict, n: int = 3) -> List[str]:
    """Lines naming the ``n`` worst leaves of each kind, with both norms."""
    lines = []
    for kind, gaps in leaf_gaps(prog, ref).items():
        for k in sorted(gaps, key=gaps.get, reverse=True)[:n]:
            lines.append(f"{kind} {k}: gap {gaps[k]:.3e}, program "
                         f"{prog[kind].get(k, float('nan')):.9e}, reference "
                         f"{ref[kind][k]:.9e}")
    return lines


def q_gap(Qs: List[np.ndarray], ref_q: Dict[str, np.ndarray],
          ks: List[int]) -> float:
    """The largest |Q - Q_ref| over every row and head."""
    if len(Qs) != len(ks):
        return float("inf")
    gap = 0.0
    for k, q in zip(sorted(ks), Qs):
        r = ref_q[f"k{k}"]
        if q.shape != r.shape:
            return float("inf")
        d = np.abs(q.astype(np.float64) - r)
        gap = max(gap, float(np.max(d)) if np.isfinite(d).all()
                  else float("inf"))
    return gap


def p_outside(Ps: List[np.ndarray], params: Dict, ks: List[int], M: int
              ) -> float:
    """P entries outside [0, 1] or not finite, and entries of the returned P
    that differ from the returned parameters' decoders."""
    bad = 0
    for k, P in zip(sorted(ks), Ps):
        P = np.asarray(P)
        bad += int(np.count_nonzero(~((P >= 0) & (P <= 1))))
        dec = np.asarray(params["decoders"][f"k{k}"]).T[:M]
        bad += int(np.count_nonzero(dec != P)) if dec.shape == P.shape \
            else P.size
    return float(bad)


def device_info(device) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def host_memory() -> str:
    """The host's MemTotal line of /proc/meminfo."""
    try:
        with open("/proc/meminfo") as f:
            return next((line.split(":", 1)[1].strip() for line in f
                         if line.startswith("MemTotal")), "unknown")
    except OSError:
        return "unknown"


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, ref_chunk: int = 65536, controls: bool = False
        ) -> Dict:
    """One run of ``cell``; returns the result line's object. With
    ``controls`` (benchmark/control.py) it also holds, at each replayed
    window step, the reference with TF32 products and the half-batch fault
    against the reference, under ``readings``."""
    config, traffic = cell.config, cell.traffic
    from neural_admixture_tpu_torch import _build
    logging.basicConfig(stream=sys.stderr, level=logging.WARNING,
                        format="%(message)s")
    if torch.device(device).type == "cuda":
        _build.build()
    N, M = int(traffic["samples"]), int(traffic["snps"])
    m_pad = sim.padded_snps(traffic)
    batch, blk = int(config["batch_size"]), int(config["sample_block"])
    log_every = int(config["log_every"])
    ks = sorted(int(k) for k in config["ks"])
    betas = tuple(config["betas"])
    adam = (M, float(config["learning_rate"]), betas,
            float(config["adam_eps"]), ref_chunk)

    t0 = time.perf_counter()
    panel, P_star = sim.simulate_panel(traffic, seed, device)
    params = sim.init_params(config, P_star, m_pad, seed, device)
    del P_star
    say(f"[set-up] panel {panel.shape} and weights: "
        f"{time.perf_counter() - t0:.1f} s")

    # Warm-up: two full batches and the remainder, six epochs.
    b_round, nb, b_rem, _ = plan_maker.geometry(N, batch, blk)
    n_warm = min(N, 2 * b_round + b_rem)
    warm_plans = plan_maker.epoch_plans(n_warm, batch, blk, WARM_EPOCHS,
                                        seed + 1)
    from neural_admixture_tpu_torch.train.engine import NeuralAdmixtureTrainer
    t0 = time.perf_counter()
    warm = NeuralAdmixtureTrainer(train_config(cell, WARM_EPOCHS, seed,
                                               device))
    warm.launch_training(None, panel[:n_warm], None, M, n_warm,
                         init_params=params,
                         plans=lambda e: warm_plans[e])
    W, period = log_periods(warm.epoch_seconds, N / n_warm, seconds,
                            log_every)
    if trace:
        W = max(W, 2)
    epochs = log_every * W + 1
    say(f"[set-up] warm-up {time.perf_counter() - t0:.1f} s; a log period "
        f"~{period:.2f} s; W = {W}, {epochs} epochs")
    warm_phase = dict(warm.phase_seconds)
    del warm

    plans = plan_maker.epoch_plans(N, batch, blk, epochs, seed)
    targets = window_steps(nb, epochs)
    p0 = reference.to_device(params, device)
    watch = Steps(CHECK_STEPS, betas[0], p0, [i for i, _, _ in targets])
    del p0
    window = Window(plans, device, trace, log_every)
    trainer = observed_trainer(watch)(train_config(cell, epochs, seed,
                                                   device))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    Qs, Ps, out_params = trainer.launch_training(
        None, panel, None, M, N, init_params=params, plans=window)
    sync(device)
    t_return = time.perf_counter()
    if window.t_open is None:
        raise RuntimeError("the measured call never asked for epoch 1")
    results_s = trainer.phase_seconds.get("results", 0.0)
    dev = device_info(device)

    r = Run(samples=N * (epochs - 1),
            window_s=t_return - window.t_open - results_s,
            setup_s=window.t_open - t_start,
            phase=dict(trainer.phase_seconds), warm_phase=warm_phase,
            M=M, D=int(config["n_components"]), ks=ks)
    say(f"[window] {r.window_s:.3f} s ({t_return - window.t_open:.3f} s to "
        f"the return, less the results phase {results_s:.3f} s), "
        f"{r.samples} samples; set-up {r.setup_s:.1f} s; phases {r.phase}")
    result = {"correct": False, "attempted": (epochs - 1) * nb,
              "failed": 0, "metrics": {}, "device": dev}
    if trace:
        r.events = window.events()
        begin = trace_reader.marker(r.events, PERIOD_BEGIN)
        end = trace_reader.marker(r.events, PERIOD_END)
        r.period = (begin, end)
        logged = [e % log_every == 0 for e in range(TRACE_FIRST,
                                                    TRACE_FIRST + log_every)]
        r.period_steps = [(b_round if i < nb - 1 else b_rem, lg)
                          for lg in logged for i in range(nb)]
        busy = trace_reader.busy_us(r.events, begin, end)
        dev["busy_s"] = busy * 1e-6
        dev["window_s"] = (end - begin) * 1e-6
        result["breakdown"] = {
            "device_ops": trace_reader.device_ops(r.events, begin, end),
            "idle_gaps": trace_reader.idle_gaps(
                r.events, begin, end, skip=(PERIOD_BEGIN, PERIOD_END))}
    metrics = cell.per_layer if trace else cell.end_to_end
    for m in metrics:
        kind = "metrics" if trace else "end_to_end"
        value = spec.reader(kind, m["name"])(r)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    r.events = []

    # The check, once the window has closed and the program's state is gone.
    del trainer
    t0 = time.perf_counter()
    order = plan_maker.pre_shuffle(N, seed)

    def batch_of(epoch: int, j: int) -> torch.Tensor:
        """The packed rows of batch j of ``epoch``'s plan (its real rows)."""
        ids = plans[epoch][0][j] if j < nb - 1 else plans[epoch][1]
        rows = plan_maker.batch_rows(ids, blk)
        return torch.from_numpy(panel[order[rows[rows < N]]]).to(device)

    prog = watch.numbers()
    ref = reference.train_steps(params, [batch_of(0, j) for j in
                                         range(CHECK_STEPS)], *adam[:4],
                                ref_chunk)
    numbers = check_numbers(prog, ref)
    for line in worst_leaves(prog, ref):
        say(f"[check] first steps: {line}")
    say(f"[check] first steps' losses: program {prog['loss']} reference "
        f"{ref['loss']}")

    inf = float("inf")
    kinds = ("loss_gap", "grad_gap", "change_gap", "change_gap_median")
    win = {k: 0.0 for k in kinds}
    readings = {"control": dict(win), "half": dict(win)}
    for i, e, j in targets:
        prog_i, got = watch.window_numbers(i), watch.window_state(i)
        watch.window.pop(i, None)
        if prog_i is None or got is None:
            say(f"[check] window step {i} (epoch {e}, batch {j}): no state")
            win = {k: inf for k in kinds}
            continue
        (state, t), packed = got, batch_of(e, j)
        logged = e % log_every == 0

        def replay(rows, **kw):
            out = reference.replay_step(state, t + 1, rows, *adam, **kw)
            return out if logged else dict(out, loss=[])
        ref_i = replay(packed)
        got_i = check_numbers(prog_i, ref_i)
        win = {k: max(win[k], got_i[k]) for k in kinds}
        say(f"[check] window step {i} (epoch {e}, batch {j}, "
            f"{packed.shape[0]} rows, Adam step {t + 1}): "
            + ", ".join(f"{k} {v!r}" for k, v in got_i.items()))
        for line in worst_leaves(prog_i, ref_i, 2):
            say(f"[check]   {line}")
        if controls:
            for kind, out in (
                    ("control", replay(packed, tf32=True)),
                    ("half", replay(packed[:packed.shape[0] // 2],
                                    scale=2.0))):
                got_c = check_numbers(out, ref_i)
                readings[kind] = {k: max(readings[kind][k], got_c[k])
                                  for k in kinds}
        del state, packed
    numbers.update({f"win_{k}": v for k, v in win.items()})
    numbers["params_differ"] = params_differ(out_params, watch.final)
    watch.final = {}
    ref_q = reference.q_pass(out_params, panel, device, ref_chunk)
    numbers["q_gap"] = q_gap(Qs, ref_q, ks)
    numbers["p_outside"] = p_outside(Ps, out_params, ks, M)
    limits = cell.workload["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    say(f"[check] {time.perf_counter() - t0:.1f} s; read, not compared: "
        + ", ".join(f"{k} {v!r}" for k, v in numbers.items()
                    if k not in limits))
    if controls:
        result["readings"] = {"program": numbers, **{
            kind: {f"win_{k}": v for k, v in got.items()}
            for kind, got in readings.items()}}
    if torch.device(device).type == "cuda":
        say(f"[card] {card_note()}; host {host_memory()}")
    for k, c in checks.items():
        say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result
