"""The training engine: one device, the packed rows resident on it or
streamed from host memory.

The JAX package's train/engine.py on one device, with its semantics:
fixed-epoch Adam (betas (0.9, 0.95), eps 1e-8) over V, the encoder and
every P, P clamped to [0, 1] after every step, the summed loss computed
and logged every ``log_every`` epochs only (every 2 in supervised mode, as
the JAX engine's engine.py:1276), then a full-data Q pass.

  * Heads: one head and one decoder per K of ``cfg.ks``, trained jointly;
    the loss sums every head's BCE (ascending K). Supervised mode
    (``pops``: one integer label per row) adds ``supervised_loss_weight``
    times the CE of the smallest K's Q against the labels
    (:func:`smallest_head`; the reference feeds the softmaxed Q as logits).
  * Batches: with ``sample_block`` > 1 the rows are pre-shuffled once
    (``np.random.default_rng(seed).permutation(N)``, undone on Q; the
    labels follow it) and batches are runs of ``sample_block`` consecutive
    resident rows; an epoch is nb - 1 full batches of real rows (the
    unmasked kernels) and one remainder batch that carries the partial
    block and the padding (the masked kernels). ``sample_block`` = 1
    samples single rows. Geometry with alignment 1 (the JAX package's XLA
    path, engine.py:176-244).
  * Resident (the default when it fits): the packed rows, V, P and the Adam
    state stay on the device; a batch is gathered there from the resident
    (n_rows, W) uint8 tensor, block by block, and goes through
    ops/fused_step.py (kernels K2-K6).
  * Host streaming (``cfg.stream``; the JAX package's make_stream_epoch_fn,
    engine.py:610-855): the packed rows stay in host memory and every
    batch is gathered there, straight through the pre-shuffle order (no
    shuffled host copy), into the stager's pinned ring and copied to the
    card (io/stage.py), pipelined across epochs. A streamed batch holds
    exactly the bytes of the resident batch, so the same plans run the same
    kernels on the same inputs: a streamed run equals a resident one. The
    Q pass streams too. ``stream=None`` streams only when the resident
    estimate does not fit the device and the streamed one does
    (:meth:`NeuralAdmixtureTrainer._capacity_policy`).
  * Three program choices, read from the JAX package's own environment
    variables where its engine reads them: ``NA_TPU_FORCE_MASKED=1`` runs
    the masked kernels on every batch (engine.py:242-243);
    ``NA_TPU_SPLIT_LOSS=1`` runs logged epochs as K6 forward + K3 backward
    instead of K4 (engine.py:421-422); ``NA_TPU_INDEXED=1`` makes the full
    batches read their blocks in place from the resident rows by block id
    (K7, engine.py:411-413) instead of gathering them; the remainder batch
    stays gathered and masked. The port indexes full batches whenever
    ``sample_block`` > 1: the JAX package's Mosaic limits (blocks of a
    multiple of 8 rows, engine.py:412, and ``INDEXED_TB_CAP``,
    ops/fused_step.py:917-925) do not apply to the card's kernels. Every
    choice computes the same numbers: the same rows reach the same
    arithmetic. Streamed batches are never indexed (no resident rows to
    index), as in the JAX package (engine.py:626-634).
  * Checkpoints (``cfg.checkpoint_every``, ``cfg.checkpoint_path``,
    ``cfg.resume``; the JAX package's engine.py:1298-1551): the parameters,
    Adam's moments and steps and the next epoch, written through a
    temporary file every ``checkpoint_every`` epochs; with them on, SIGTERM
    saves at the next epoch boundary and exits 143. No random state is
    saved: the plans and the pre-shuffle are redrawn from the seed. A
    resumed run equals the uninterrupted one, streamed or not.
  * The encoder init and the per-epoch batch plans come from CPU generators
    seeded from ``seed`` (utils/seeding.py), so a run on the card and a run
    on the CPU draw identical plans and initial weights. ``launch_training``
    also takes both from the caller (the tests hand in the JAX package's).

Left for a later slice (ROADMAP.md Queue 1): several devices (item 12).
"""
import json
import os
import signal
import sys
import time
from contextlib import closing
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..io.stage import HostStager
from ..models import qp
from ..ops.fused_step import fused_training_loss
from ..ops.loss import softmax_cross_entropy_sum
from ..ops.pack import batch_rows, packed_has_missing
from ..utils.hbm import HBM_BUDGET_FRAC, hbm_capacity_bytes
from ..utils.logger import log, setup_logging
from ..utils.metrics import fst_table
from ..utils.seeding import generator
from .chunked import chunked_forward

INFER_BATCH = 1024
# The "format" entry of a checkpoint: the layout below (params_to_numpy's
# names under "param/", Adam's state under "adam/").
CKPT_FORMAT = "neural_admixture_tpu_torch/train_state/1"

# A plan: (idx_full (nb - 1, F), idx_rem (R,)) in units of sample blocks
# (resident block ids when sample_block > 1, row ids otherwise).
Plan = Tuple[np.ndarray, np.ndarray]


@dataclass
class TrainConfig:
    epochs: int = 250
    batch_size: int = 800
    learning_rate: float = 20e-4
    seed: int = 42
    hidden_size: int = 1024
    n_components: int = 8
    ks: List[int] = field(default_factory=lambda: [3])
    supervised_loss_weight: float = 100.0
    log_every: int = 5
    progress: bool = True
    sample_block: int = 1
    device: str = "cuda"
    # Host streaming: None = auto (_capacity_policy), True, False.
    stream: Optional[bool] = None
    # Save a resumable checkpoint to checkpoint_path every N epochs (0: off);
    # resume: start from checkpoint_path when it exists.
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    resume: bool = False


def smallest_head(qs) -> str:
    """Head key of the numerically smallest K ('k10' sorts after 'k9')."""
    return min(qs, key=lambda hk: int(hk[1:]))


def block_geometry(N: int, batch_size: int, blk: int
                   ) -> Tuple[int, int, int, int]:
    """(b_round, nb, b_rem, resident_rows): an epoch is nb steps, nb - 1
    batches of b_round rows and one remainder of b_rem <= b_round rows, all
    whole blocks of ``blk`` rows; the resident rows are padded to exactly
    (nb - 1) * b_round + b_rem."""
    b_round = -(-min(batch_size, N) // blk) * blk
    nb = -(-N // b_round)
    b_rem = -(-(N - (nb - 1) * b_round) // blk) * blk
    return b_round, nb, b_rem, (nb - 1) * b_round + b_rem


def epoch_plan(gen: torch.Generator, N: int, batch_size: int, blk: int,
               n_rows: int) -> Plan:
    """One epoch's batches, from ``gen``: every real row exactly once.

    ``blk`` > 1: a permutation of the N // blk full data blocks; the full
    batches take the first (nb - 1) * F of them, the remainder the rest plus
    the partial and all-padding blocks. ``blk`` = 1: a permutation of the
    rows (with alignment 1 the remainder holds exactly the rows left)."""
    b_round, nb, _, _ = block_geometry(N, batch_size, blk)
    if blk > 1:
        F = b_round // blk
        perm = torch.randperm(N // blk, generator=gen).numpy()
        idx_full = perm[:(nb - 1) * F].reshape(nb - 1, F)
        idx_rem = np.concatenate([perm[(nb - 1) * F:],
                                  np.arange(N // blk, n_rows // blk)])
        return idx_full, idx_rem
    perm = torch.randperm(N, generator=gen).numpy()
    return (perm[:(nb - 1) * b_round].reshape(nb - 1, b_round),
            perm[(nb - 1) * b_round:])


def program_choices(blk: int, stream: bool = False
                    ) -> Tuple[bool, bool, bool]:
    """(full_real, indexed, merged) from the JAX package's environment
    variables (see the module docstring): full batches run unmasked unless
    NA_TPU_FORCE_MASKED=1; they are indexed under NA_TPU_INDEXED=1 when
    they are unmasked whole blocks of resident rows (never when
    ``stream``); logged epochs run merged (K4) unless NA_TPU_SPLIT_LOSS=1."""
    full_real = os.environ.get("NA_TPU_FORCE_MASKED") != "1"
    indexed = (full_real and blk > 1 and not stream
               and os.environ.get("NA_TPU_INDEXED") == "1")
    merged = os.environ.get("NA_TPU_SPLIT_LOSS") != "1"
    return full_real, indexed, merged


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class NeuralAdmixtureTrainer:
    """Init -> epochs -> Q pass -> results, on ``cfg.device``."""

    def __init__(self, cfg: TrainConfig):
        setup_logging()
        self.cfg = cfg
        self.ks = sorted(cfg.ks)
        self.logged_losses: Dict[int, float] = {}
        self.epoch_seconds: List[float] = []
        self.train_seconds = 0.0
        # Host-clock seconds of launch_training's phases around the epochs:
        # layout (pre-shuffle, padding, missing scan, rows to the device),
        # init (parameters, optimizer, a resumed checkpoint), q_pass,
        # results (to numpy, Fst); and of the last checkpoint save and the
        # load.
        self.phase_seconds: Dict[str, float] = {}
        self._streamed = False
        self.stager: Optional[HostStager] = None

    def _lap(self, name: str, t0: float, device) -> float:
        _sync(device)
        now = time.perf_counter()
        self.phase_seconds[name] = now - t0
        return now

    def launch_training(self, P_init: np.ndarray, packed: np.ndarray,
                        V: np.ndarray, M: int, N: int,
                        init_params: Optional[Dict] = None,
                        plans: Optional[Callable[[int], Plan]] = None,
                        pops: Optional[np.ndarray] = None
                        ) -> Tuple[List[np.ndarray], List[np.ndarray], Dict]:
        """Train and return (Qs, Ps, params): Q (N, k) in input row order
        and P (M, k) per K ascending, and the trained parameter dict (numpy,
        the JAX package's layout, V and P padded to m_pad).

        P_init: (sum(ks), M) initial P rows; packed: (N, W) uint8 host rows;
        V: (D, M) from the RSVD; ``pops``: (N,) integer labels in 0..K-1 in
        input row order, which turn on supervised mode. ``init_params``:
        the initial parameter dict (decoders included) instead of building
        one from V, P_init and draws; ``plans``: epoch -> (idx_full,
        idx_rem) instead of drawing them."""
        cfg = self.cfg
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("training was asked for a CUDA device, but no "
                               "CUDA device is available.")
        torch.backends.cuda.matmul.allow_tf32 = False
        blk = max(1, cfg.sample_block)
        batch_size = min(cfg.batch_size, N)
        W = packed.shape[1]
        m_pad = W * 4
        supervised = pops is not None
        self._supervised = supervised

        # Layout: the one-time row pre-shuffle for block sampling, then zero
        # rows up to whole blocks of whole batches; resident on the device,
        # or, streamed, only the map from resident rows to host rows.
        t_phase = time.perf_counter()
        self._row_order = None
        if blk > 1:
            self._row_order = np.random.default_rng(cfg.seed).permutation(N)
        b_round, nb, _, n_rows = block_geometry(N, batch_size, blk)
        stream = self._capacity_policy(n_rows * W, m_pad, device)
        host = np.ascontiguousarray(packed[:N])
        no_missing = not packed_has_missing(host)
        self.stager = None
        if stream:
            resident = None
            self._host_row = np.concatenate([
                np.arange(N) if self._row_order is None else self._row_order,
                np.full(n_rows - N, -1)]).astype(np.int64)
            self.stager = HostStager(device, max(b_round,
                                                 min(N, INFER_BATCH)), W)
        else:
            data = host if self._row_order is None else host[self._row_order]
            if n_rows > N:
                data = np.concatenate(
                    [data, np.zeros((n_rows - N, W), data.dtype)])
            resident = torch.from_numpy(np.ascontiguousarray(data)).to(device)
        col_mask = (torch.arange(m_pad, device=device) < M).to(torch.float32)
        pops_dev = self._prepare_pops(pops, N, device) if supervised else None
        t_phase = self._lap("layout", t_phase, device)

        if init_params is None:
            init_params = qp.init_params(generator(cfg.seed, 0), V.T, P_init,
                                         cfg.hidden_size, self.ks, m_pad)
        model = qp.params_from_numpy(init_params, self.ks, device)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                               betas=(0.9, 0.95), eps=1e-8)
        if plans is None:
            def plans(epoch):
                return epoch_plan(generator(cfg.seed, 1, epoch), N,
                                  batch_size, blk, n_rows)
        start_epoch = 0
        if cfg.resume and cfg.checkpoint_path:
            start_epoch = self._load_checkpoint(model, opt)
        t_phase = self._lap("init", t_phase, device)

        log.info("")
        log.info("    Starting training...")
        log.info("")
        if start_epoch:
            log.info(f"    Resuming from epoch {start_epoch}.")
        self._run_epochs(model, opt, start_epoch, plans, N, n_rows, blk,
                         host, resident, col_mask, pops_dev, no_missing,
                         device)

        t_phase = time.perf_counter()
        with torch.no_grad():
            qs = chunked_forward(
                lambda b: model(b, no_missing),
                host if stream else resident, N, min(N, INFER_BATCH),
                device, order=self._row_order, stager=self.stager)
        if self.stager is not None:
            self.stager.close()
        Qs = [qs[f"k{k}"] for k in self.ks]
        if self._row_order is not None:
            Qs = [self._unshuffle_rows(q) for q in Qs]
        t_phase = self._lap("q_pass", t_phase, device)
        log.info("")
        log.info("    Training finished!")
        log.info("")
        params = qp.params_to_numpy(model)
        self.display_divergences(params, M)
        Ps = [params["decoders"][f"k{k}"].T[:M].astype(np.float32)
              for k in self.ks]
        self._lap("results", t_phase, device)
        return Qs, Ps, params

    def _batches(self, plans, start_epoch: int, N: int, n_rows: int,
                 blk: int, host: np.ndarray, resident, indexed: bool,
                 device) -> Iterator[Tuple]:
        """Every step from ``start_epoch`` on, as (epoch, full, rows, xb,
        blk_idx): the batch's resident rows (int64, on the device), its
        packed rows (gathered on the device, or streamed through the stager)
        and, for an indexed batch, its block ids (xb is then the resident
        tensor). Each epoch's plan is drawn once."""
        cfg = self.cfg
        memo: Dict[int, Plan] = {}

        def plan(epoch):
            if epoch not in memo:
                memo.clear()
                memo[epoch] = plans(epoch)
            return memo[epoch]

        def host_jobs():
            """The host rows of each streamed batch: resident row r is host
            row _host_row[r] (-1: a zero padding row)."""
            for epoch in range(start_epoch, cfg.epochs):
                idx_full, idx_rem = plan(epoch)
                for idx in list(idx_full) + [idx_rem]:
                    rows = (np.asarray(idx, np.int64)[:, None] * blk
                            + np.arange(blk)).reshape(-1)
                    yield self._host_row[np.minimum(rows, n_rows - 1)]

        staged = (self.stager.batches(host, host_jobs())
                  if resident is None else None)
        try:
            for epoch in range(start_epoch, cfg.epochs):
                # The plan goes to the device once per epoch: a pageable
                # copy per step would wait for the previous step's kernels.
                idx_full, idx_rem = (
                    torch.from_numpy(np.array(a, dtype=np.int64)).to(device)
                    for a in plan(epoch))
                blk_ids = idx_full.to(torch.int32) if indexed else None
                for i in range(len(idx_full) + 1):
                    full = i < len(idx_full)
                    rows = batch_rows(idx_full[i] if full else idx_rem, blk)
                    if staged is not None:
                        yield epoch, full, rows, next(staged), None
                    elif indexed and full:
                        # Read in place: all rows real (full_real), no copy.
                        yield epoch, full, rows, resident, blk_ids[i]
                    else:
                        yield epoch, full, rows, resident.index_select(
                            0, torch.clamp(rows, max=n_rows - 1)), None
        finally:
            if staged is not None:
                staged.close()

    def _run_epochs(self, model, opt, start_epoch: int, plans, N: int,
                    n_rows: int, blk: int, host: np.ndarray, resident,
                    col_mask, pops_dev, no_missing: bool, device) -> None:
        """The epoch loop from ``start_epoch``: the steps, the logged losses,
        the periodic checkpoints and the SIGTERM save (the JAX package's
        _run_epochs, engine.py:1298-1445)."""
        cfg = self.cfg
        full_real, indexed, merged = program_choices(blk, resident is None)
        supervised = pops_dev is not None
        log_every = 2 if supervised else cfg.log_every
        ckpt_on = bool(cfg.checkpoint_every and cfg.checkpoint_path)
        # Preemption: with checkpoints on, SIGTERM (what preemptible
        # schedulers deliver) saves a resumable checkpoint at the next epoch
        # boundary and exits 143; --resume continues bit-exactly. Signals
        # reach only the main thread, so elsewhere this stays off.
        self._preempted = False
        prev_sigterm, installed = None, False
        if ckpt_on:
            def _on_sigterm(signum, frame):
                self._preempted = True
            try:
                prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
                installed = True
            except ValueError:  # not the main thread
                pass

        self.logged_losses, self.epoch_seconds = {}, []
        _sync(device)
        t_train = t_epoch = time.perf_counter()
        loss_sum = None
        steps = self._batches(plans, start_epoch, N, n_rows, blk, host,
                              resident, indexed, device)
        try:
            with closing(steps):
                for epoch, full, rows, xb, blk_idx in steps:
                    logged = epoch % log_every == 0
                    row_w = (torch.ones(rows.shape[0], device=device)
                             if blk_idx is not None
                             else (rows < N).to(torch.float32))
                    opt.zero_grad(set_to_none=True)
                    loss, qs = fused_training_loss(
                        model, xb, col_mask, row_w, not (full and full_real),
                        no_missing, logged, merged, blk_idx, blk)
                    if supervised:
                        pops_b = pops_dev[torch.clamp(rows, max=N - 1)]
                        loss = loss + cfg.supervised_loss_weight * \
                            softmax_cross_entropy_sum(
                                qs[smallest_head(qs)], pops_b, row_w)
                    loss.backward()
                    opt.step()
                    model.restrict_P()
                    if logged:
                        loss = loss.detach()
                        loss_sum = loss if loss_sum is None else \
                            loss_sum + loss
                    if full:
                        continue
                    # The epoch's last step.
                    if logged:
                        self.logged_losses[epoch] = float(loss_sum)
                        loss_sum = None
                        log.info(f"            Loss in epoch {epoch:3d} is "
                                 f"{self.logged_losses[epoch]:,.0f}")
                    _sync(device)
                    now = time.perf_counter()
                    self.epoch_seconds.append(now - t_epoch)
                    if cfg.progress:
                        print(f"\r    Epochs: {epoch + 1}/{cfg.epochs}",
                              end="", file=sys.stderr, flush=True)
                    saved = ckpt_on and (epoch + 1) % cfg.checkpoint_every \
                        == 0
                    if saved:
                        self._save_checkpoint(epoch + 1, model, opt)
                    if self._preempted and epoch + 1 < cfg.epochs:
                        if not saved:
                            self._save_checkpoint(epoch + 1, model, opt)
                        if cfg.progress:
                            print(file=sys.stderr)
                        log.info(f"    SIGTERM received: resumable "
                                 f"checkpoint saved at epoch {epoch + 1} "
                                 f"({cfg.checkpoint_path}); exiting. Restart "
                                 "with --resume to continue.")
                        raise SystemExit(143)
                    t_epoch = time.perf_counter()
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_sigterm
                              if prev_sigterm is not None else signal.SIG_DFL)
        if cfg.progress and start_epoch < cfg.epochs:
            print(file=sys.stderr)
        self.train_seconds = time.perf_counter() - t_train
        epochs_run = cfg.epochs - start_epoch
        if epochs_run > 0 and self.train_seconds > 0:
            log.info(f"    Training throughput: "
                     f"{N * epochs_run / self.train_seconds:,.0f} samples/s "
                     f"({self.train_seconds:.2f}s for {epochs_run} epochs).")

    def _capacity_policy(self, data_bytes: int, m_pad: int, device) -> bool:
        """Resident or host-streamed training (sets ``self._streamed``), by
        the JAX package's estimate for its kernels (engine.py:1085-1160),
        which decode in registers: no f32 unpack transient. On one device:
        the resident packed rows, one packed batch and the SNP-plane state
        (:meth:`_plane_state_bytes`) against HBM_BUDGET_FRAC of the
        capacity; streamed, the same without the resident rows."""
        cfg = self.cfg
        cap_gb = hbm_capacity_bytes(device) / 2**30
        batch_bytes = cfg.batch_size * m_pad // 4
        plane = self._plane_state_bytes(m_pad)
        per_chip = data_bytes + batch_bytes + plane
        per_chip_stream = batch_bytes + plane
        budget = HBM_BUDGET_FRAC * cap_gb * 2**30
        resident_fits = per_chip <= budget
        stream = cfg.stream
        if stream is None:
            stream = not resident_fits and per_chip_stream <= budget
        self._streamed = bool(stream)
        if stream:
            log.info(
                f"    Host-streaming (out-of-core) training: packed "
                f"genotypes ({data_bytes / 2**30:.1f} GiB) stay in host "
                f"memory; estimated per-chip HBM need drops to "
                f"~{per_chip_stream / 2**30:.1f} GiB.")
        elif not resident_fits:
            log.warning(
                f"    Estimated per-chip HBM need ~{per_chip / 2**30:.1f} "
                f"GiB exceeds ~{cap_gb:.0f} GiB capacity; training will "
                f"likely OOM. Use --stream 1 (single-device out-of-core).")
        return self._streamed

    def _plane_state_bytes(self, m_pad: int) -> int:
        """f32 SNP-plane training state: V plus every decoder P row, each
        held four times: the parameter, its gradient and Adam's two
        moments (the JAX package counts three, engine.py:1553-1557)."""
        plane_rows = self.cfg.n_components + sum(self.ks)
        return m_pad * plane_rows * 4 * 4

    def _ckpt_meta(self) -> Dict:
        """The hyperparameters that must match between save and resume (the
        JAX package's _ckpt_meta without its mesh shape): a restored Adam
        state stepped through another objective diverges silently."""
        cfg = self.cfg
        return {
            "ks": list(self.ks),
            "batch_size": int(cfg.batch_size),
            "hidden_size": int(cfg.hidden_size),
            "n_components": int(cfg.n_components),
            "seed": int(cfg.seed),
            "sample_block": int(max(1, cfg.sample_block)),
            "learning_rate": float(cfg.learning_rate),
            "supervised": bool(self._supervised),
            "supervised_loss_weight": float(cfg.supervised_loss_weight),
        }

    def _save_checkpoint(self, epoch: int, model, opt) -> None:
        """Write the resumable state to ``cfg.checkpoint_path`` through a
        temporary file: ``format``, ``epoch`` (the next one), ``meta``
        (JSON), ``param/{name}`` in params_to_numpy's layout and, per
        parameter, ``adam/{name}/exp_avg``, ``exp_avg_sq`` (the same layout)
        and ``step``, as plain arrays."""
        t = time.perf_counter()
        arrays = {"format": np.bytes_(CKPT_FORMAT.encode()),
                  "epoch": np.int64(epoch),
                  "meta": np.bytes_(json.dumps(self._ckpt_meta()).encode())}
        for name, p, transpose in qp.param_layout(model):
            arrays[f"param/{name}"] = qp.to_layout(p, transpose)
            state = opt.state.get(p)
            if state:
                for key in ("exp_avg", "exp_avg_sq"):
                    arrays[f"adam/{name}/{key}"] = qp.to_layout(state[key],
                                                                transpose)
                arrays[f"adam/{name}/step"] = np.int64(int(state["step"]))
        path = self.cfg.checkpoint_path
        tmp = f"{path}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        self.phase_seconds["save"] = time.perf_counter() - t

    def _load_checkpoint(self, model, opt) -> int:
        """Restore ``cfg.checkpoint_path`` into the model and the optimizer
        and return its next epoch; 0 (start fresh) when there is no file.
        Refuses a file of another layout and any hyperparameter change."""
        path = self.cfg.checkpoint_path
        if not os.path.exists(path):
            return 0
        t = time.perf_counter()
        with np.load(path) as data:
            fmt = (bytes(data["format"]).decode() if "format" in data.files
                   else None)
            if fmt != CKPT_FORMAT:
                raise ValueError(
                    f"{path} is not a checkpoint of this package (format "
                    f"{fmt!r}, expected {CKPT_FORMAT!r}; the JAX package "
                    "writes another layout); refusing to resume.")
            saved = json.loads(bytes(data["meta"]).decode())
            now = self._ckpt_meta()
            diffs = {k: (saved[k], now[k]) for k in now
                     if k in saved and saved[k] != now[k]}
            if diffs:
                raise ValueError(
                    "Checkpoint hyperparameters do not match this run; "
                    "refusing to resume. Mismatches (checkpoint vs now): "
                    + ", ".join(f"{k}: {a} vs {b}"
                                for k, (a, b) in sorted(diffs.items())))
            epoch = int(data["epoch"])
            layout = qp.param_layout(model)
            with torch.no_grad():
                for name, p, transpose in layout:
                    p.copy_(qp.from_layout(data[f"param/{name}"], transpose))
            index = {id(p): i for i, p in
                     enumerate(opt.param_groups[0]["params"])}
            state = {}
            for name, p, transpose in layout:
                if f"adam/{name}/step" in data.files:
                    state[index[id(p)]] = {
                        "step": torch.tensor(
                            float(data[f"adam/{name}/step"])),
                        **{key: qp.from_layout(data[f"adam/{name}/{key}"],
                                               transpose)
                           for key in ("exp_avg", "exp_avg_sq")}}
        opt.load_state_dict({"state": state,
                             "param_groups": opt.state_dict()["param_groups"]})
        self.phase_seconds["load"] = time.perf_counter() - t
        return epoch

    def _prepare_pops(self, pops, N: int, device) -> torch.Tensor:
        """The labels in resident row order (they follow the pre-shuffle,
        as the JAX engine's engine.py:1215-1232), on the device."""
        pops_np = np.asarray(pops, dtype=np.int64)
        if pops_np.shape != (N,):
            raise ValueError(f"pops must hold one label per sample: shape "
                             f"{pops_np.shape}, N = {N}")
        if self._row_order is not None:
            pops_np = pops_np[self._row_order]
        return torch.from_numpy(pops_np).to(device)

    def _unshuffle_rows(self, q: np.ndarray) -> np.ndarray:
        out = np.empty_like(q)
        out[self._row_order] = q
        return out

    def display_divergences(self, params: Dict, M: int) -> None:
        log.info("    Results:")
        for k in self.ks:
            P = np.asarray(params["decoders"][f"k{k}"]).T[:M]  # (M, k)
            log.info(f"\n            Fst divergences between estimated "
                     f"populations: (K = {k})")
            log.info("")
            for line in fst_table(P):
                log.info(line)
            log.info("\n")
