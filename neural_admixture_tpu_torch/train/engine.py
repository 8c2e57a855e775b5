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
  * A profiler trace (``cfg.profile_dir``; the JAX package's
    jax.profiler trace, engine.py:1348-1439): ``torch.profiler`` records
    the epoch loop, the host and, on a card, its kernels and copies through
    CUPTI, with one ``record_function`` span per epoch (``epoch N``), and
    writes a Chrome trace (:func:`trace_path`; on a grid one file per rank)
    when the loop ends, by an exception or SIGTERM's exit too. On a card
    that it cannot trace it raises: a trace of the host alone is not
    written in its place. The trace changes no number of the run.
  * Spans (utils/trace.py :func:`span`), in this trace or any other that
    a caller records: inside each ``epoch N``, flat and in order,
    ``na.plan`` (the epoch's plan drawn and moved to the device), then per
    step ``na.batch`` (its rows and packed batch), ``na.forward`` (the
    step function up to the backward), ``na.backward``, ``na.adam``
    (``opt.step`` and ``zero_grad``) and ``na.clamp`` (``restrict_P``, the
    logged loss's sum), then ``na.epoch_end`` (the loss read-back, the
    synchronise, the log line, progress, checkpoint and SIGTERM check).
    ``phase_seconds`` splits layout into ``layout.host`` and
    ``layout.upload`` (absent when streamed) and init into
    ``init.params`` and ``init.optimizer``.
  * The encoder init and the per-epoch batch plans come from CPU generators
    seeded from ``seed`` (utils/seeding.py), so a run on the card and a run
    on the CPU draw identical plans and initial weights. ``launch_training``
    also takes both from the caller (the tests hand in the JAX package's).
  * A grid of ranks (the trainer's ``grid``, parallel/grid.py; the JAX
    package's (data, snp) mesh, engine.py:883-1190): a D x S grid runs what
    the JAX package runs in a D-process run on a (D, S) mesh, on its XLA
    path's geometry (alignment D: :func:`block_geometry`). Data row d holds
    that run's process d's rows (:meth:`sample_shard`), pre-shuffled per
    process under block sampling (:func:`shard_row_order`) and padded to
    rows_per_process; rank (d, s) keeps SNP block s of them on its device.
    The epoch plan is global and the same on every rank; data row d takes
    batch positions [d B/D, (d+1) B/D) and gets the rows it does not hold
    from the other data rows over the data group (one all_to_all a step:
    the counts follow from the plan and the ownership, no other message;
    none when every row is local, as under ``NA_TPU_STRATIFIED=1``,
    :func:`stratified_plan`). The step is parallel/sharded_step.py's; full
    batches are gathered, never indexed (as the JAX engine indexes only
    without a mesh). A padding row of per-row sampling is read as a zero
    row by the data row whose slice holds it. The Q pass runs per data row
    and its rows are gathered to every rank, and so are the parameters.
  * Host streaming on a grid (the JAX package's multi-host
    make_stream_epoch_fn, engine.py:610-855): the rank's block stays in
    host memory; with more than one data row the plan is the stratified
    one (every row of a data row's slice is its own, as the JAX package
    forces for a streamed multi-process run, engine.py:1131-1140), so each
    step's slice goes through the rank's stager and no row is exchanged.
    A streamed grid equals the resident grid under NA_TPU_STRATIFIED=1 bit
    for bit; so does its Q pass, staged chunk by chunk.
  * Checkpoints on a grid (engine.py:1447-1536): the file is the one-device
    layout at full width, V, the Ps and their moments gathered over the snp
    group and written by rank 0; the meta holds the grid's shape, which a
    resume may change (the file is cut into the new grid's blocks). The
    ranks agree on the file and on SIGTERM, so they save and stop at one
    epoch.
  * ``NA_TPU_EMULATE_PROC_SHARDS="P,D"`` (the JAX package's, engine.py:
    985-1016): one rank lays its rows out as a P-process run over a D-wide
    data axis does, with that run's geometry and, under block sampling, its
    per-process pre-shuffle, another sampling policy than one rank's global
    pre-shuffle. A grid's run is held to a one-rank run only under it.
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
from ..io.writers import _flatten, _unflatten
from ..models import qp
from ..ops.fused_step import fused_training_loss
from ..ops.loss import softmax_cross_entropy_sum
from ..ops.pack import batch_rows, packed_has_missing
from ..parallel.distributed import (PREEMPTED_EXIT, gather_snp,
                                    host_sample_shard, rows_per_process,
                                    to_host)
from ..parallel.grid import DATA_AXIS, SNP_AXIS, Grid, shard_params
from ..parallel.sharded_step import infer_q_sharded, make_sharded_loss_and_grad
from ..utils.hbm import HBM_BUDGET_FRAC, hbm_capacity_bytes
from ..utils.logger import log, setup_logging
from ..utils.metrics import fst_table
from ..utils.seeding import generator
from ..utils.trace import span
from .chunked import chunked_forward

INFER_BATCH = 1024
NO_CUPTI = ("--profile_dir: the profiler cannot trace the CUDA device (CUPTI "
            "is not available to this PyTorch); a trace of the host alone "
            "would hide the card's time")
# The "format" entry of a checkpoint: the layout below (params_to_numpy's
# names under "param/", Adam's state under "adam/").
CKPT_FORMAT = "neural_admixture_tpu_torch/train_state/1"
# The parameter-shaped groups of a checkpoint: the parameters, then Adam's
# two moments of each.
CKPT_GROUPS = ("param", "exp_avg", "exp_avg_sq")
# Each rank's SNP block must be whole 32-bit words of 16 SNPs: every kernel
# reads its packed rows as u32 words (m_pad % (16 * S) == 0).
SNP_QUANTUM = 16

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
    # The grid (n_data, n_snp) of a run over several ranks: None = auto
    # over the ranks there are (NeuralAdmixtureTrainer._pick_mesh).
    mesh_shape: Optional[Tuple[int, int]] = None
    # A torch.profiler trace of the epochs, written into this directory.
    profile_dir: Optional[str] = None


def trace_path(profile_dir: str, rank: int) -> str:
    """The first free name of a rank's trace in ``profile_dir``:
    ``epochs_rank{rank}.json``, then ``_1``, ``_2``... for each later run
    into the same directory (a fold, a restart, another command)."""
    os.makedirs(profile_dir, exist_ok=True)
    stem = os.path.join(profile_dir, f"epochs_rank{rank}")
    path, n = f"{stem}.json", 0
    while os.path.exists(path):
        n += 1
        path = f"{stem}_{n}.json"
    return path


def _ckpt_key(group: str, name: str) -> str:
    """The file's key of parameter ``name``'s entry in ``group`` (one of
    CKPT_GROUPS, or Adam's "step")."""
    return f"param/{name}" if group == "param" else f"adam/{name}/{group}"


def smallest_head(qs) -> str:
    """Head key of the numerically smallest K ('k10' sorts after 'k9')."""
    return min(qs, key=lambda hk: int(hk[1:]))


def shard_quantum(d_sz: int, blk: int) -> int:
    """The row quantum of block sampling on a ``d_sz``-wide data axis
    (the JAX package's XLA path: lcm(d_sz, d_sz * blk))."""
    return int(np.lcm(d_sz, d_sz * blk))


def shard_row_order(N: int, seed: int, n_proc: int, rows_pp: int
                    ) -> np.ndarray:
    """Resident row -> input row under the per-process pre-shuffle of block
    sampling over ``n_proc`` processes (data rows) of ``rows_pp`` rows each:
    each process shuffles its own input rows, seeded by (seed, process), so
    every rank can rebuild the whole map without a message. Real resident
    rows stay contiguous at [0, N) (only the tail process is partial). The
    JAX package's shard_row_order (engine.py:153-174)."""
    parts = []
    for p in range(n_proc):
        s = min(p * rows_pp, N)
        e = min(s + rows_pp, N)
        if e > s:
            parts.append(s + np.random.default_rng([seed, p])
                         .permutation(e - s))
    return np.concatenate(parts)


def block_geometry(N: int, batch_size: int, blk: int, d_sz: int = 1
                   ) -> Tuple[int, int, int, int]:
    """(b_round, nb, b_rem, resident_rows): an epoch is nb steps, nb - 1
    batches of b_round rows and one remainder of b_rem <= b_round rows, on a
    ``d_sz``-wide data axis (the JAX package's XLA-path geometry,
    engine.py:176-244).

    ``blk`` > 1: all whole blocks of ``blk`` rows, multiples of d_sz * blk;
    the resident rows are padded to exactly (nb - 1) * b_round + b_rem.
    ``blk`` = 1: nb - 1 batches of ``batch_size`` rows and the rest, each
    widened with padding rows to a multiple of d_sz; the resident rows are
    the N rows."""
    B = min(batch_size, N)
    if blk == 1:
        nb = -(-N // B)
        rem = N - (nb - 1) * B
        return -(-B // d_sz) * d_sz, nb, -(-rem // d_sz) * d_sz, N
    q = d_sz * blk
    b_round = -(-B // q) * q
    nb = -(-N // b_round)
    b_rem = -(-(N - (nb - 1) * b_round) // q) * q
    return b_round, nb, b_rem, (nb - 1) * b_round + b_rem


def epoch_plan(gen: torch.Generator, N: int, batch_size: int, blk: int,
               n_rows: int, d_sz: int = 1) -> Plan:
    """One epoch's batches, from ``gen``: every real row exactly once.

    ``blk`` > 1: a permutation of the N // blk full data blocks; the full
    batches take the first (nb - 1) * F of them, the remainder the rest plus
    the partial and all-padding blocks. ``blk`` = 1: a permutation of the
    rows, each batch widened to its :func:`block_geometry` width with the
    padding row id N (none with ``d_sz`` = 1)."""
    b_round, nb, b_rem, _ = block_geometry(N, batch_size, blk, d_sz)
    if blk > 1:
        F = b_round // blk
        perm = torch.randperm(N // blk, generator=gen).numpy()
        idx_full = perm[:(nb - 1) * F].reshape(nb - 1, F)
        idx_rem = np.concatenate([perm[(nb - 1) * F:],
                                  np.arange(N // blk, n_rows // blk)])
        return idx_full, idx_rem
    B = min(batch_size, N)
    perm = torch.randperm(N, generator=gen).numpy()
    idx_full = perm[:(nb - 1) * B].reshape(nb - 1, B)
    tail = perm[(nb - 1) * B:]
    if b_round == B and b_rem == tail.size:
        return idx_full, tail
    return (np.concatenate([idx_full, np.full((nb - 1, b_round - B), N)],
                           axis=1),
            np.concatenate([tail, np.full(b_rem - tail.size, N)]))


def stratified_plan(perm: Callable[[int, int], np.ndarray], ep: int,
                    blk: int, N: int, n_rows: int, b_round: int, nb: int,
                    b_rem: int) -> Plan:
    """Host-partition-stratified sampling (the JAX package's
    _stratified_plan, engine.py:247-310): each of the ``ep`` partitions
    (data rows: contiguous blocks of n_rows / ep resident rows) fills its
    own shard of every batch from its own rows, so no row crosses data
    rows. ``perm(p, n)`` is partition p's permutation of n units (the JAX
    package draws it from fold_in(key, p)). Units are ``blk``-row blocks
    (padding blocks included, so every batch runs masked) or single rows
    padded with the row id N. Returns global resident ids, batch columns
    [p F_p, (p + 1) F_p) holding partition p's picks."""
    if n_rows % ep:
        raise ValueError(f"{n_rows} resident rows over {ep} partitions")
    rows_pp = n_rows // ep
    unit = blk * ep if blk > 1 else ep
    if b_round % unit or b_rem % unit:
        raise ValueError(f"batches of {b_round} and {b_rem} rows do not "
                         f"split into units of {unit}")
    if blk > 1:
        upp = rows_pp // blk
        F_p, R_p = b_round // (blk * ep), b_rem // (blk * ep)
        if (nb - 1) * F_p + R_p != upp:
            raise ValueError("the plan does not cover every block once")
        perms = np.stack([np.asarray(perm(p, upp)) + p * upp
                          for p in range(ep)])
    else:
        F_p, R_p = b_round // ep, b_rem // ep
        supply = (nb - 1) * F_p + R_p
        parts = []
        for p in range(ep):
            n_local = min(rows_pp, max(0, N - p * rows_pp))
            if supply < n_local:
                raise ValueError("the plan does not cover every row once")
            pp = np.asarray(perm(p, max(n_local, 1)))[:n_local] + p * rows_pp
            parts.append(np.concatenate(
                [pp, np.full(supply - n_local, N, pp.dtype)]))
        perms = np.stack(parts)
    idx_full = (perms[:, :(nb - 1) * F_p]
                .reshape(ep, nb - 1, F_p).transpose(1, 0, 2)
                .reshape(nb - 1, ep * F_p))
    idx_rem = perms[:, (nb - 1) * F_p:].reshape(ep * R_p)
    return idx_full, idx_rem


def emulated_shards() -> Optional[Tuple[int, int]]:
    """(P, D) of NA_TPU_EMULATE_PROC_SHARDS="P,D", or None."""
    emul = os.environ.get("NA_TPU_EMULATE_PROC_SHARDS")
    if not emul:
        return None
    p, d = (int(v) for v in emul.split(","))
    return p, d


def check_snp_axis(m_pad: int, n_snp: int) -> None:
    """Raise unless each of ``n_snp`` SNP blocks is whole 32-bit words of
    every packed row (the JAX package's message, engine.py:1616-1618)."""
    if m_pad % (n_snp * SNP_QUANTUM):
        raise ValueError(
            f"m_pad={m_pad} is not divisible by n_snp={n_snp} x "
            f"{SNP_QUANTUM}; choose a smaller snp mesh axis")


def program_choices(blk: int, stream: bool = False, sharded: bool = False,
                    rows_real: bool = True) -> Tuple[bool, bool, bool]:
    """(full_real, indexed, merged) from the JAX package's environment
    variables (see the module docstring): full batches run unmasked unless
    NA_TPU_FORCE_MASKED=1 or some may hold padding rows (not
    ``rows_real``); they are indexed under NA_TPU_INDEXED=1 when they are
    unmasked whole blocks of resident rows (never when ``stream`` or
    ``sharded``: a grid gathers); logged epochs run merged (K4) unless
    NA_TPU_SPLIT_LOSS=1."""
    full_real = rows_real and os.environ.get("NA_TPU_FORCE_MASKED") != "1"
    indexed = (full_real and blk > 1 and not stream and not sharded
               and os.environ.get("NA_TPU_INDEXED") == "1")
    merged = os.environ.get("NA_TPU_SPLIT_LOSS") != "1"
    return full_real, indexed, merged


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EpochTrace:
    """A torch.profiler trace of one epoch loop on ``device``: the host, and
    on a card its kernels and copies (CUPTI), with one ``epoch N`` span an
    epoch; :meth:`close` stops it and writes it as a Chrome trace into
    ``profile_dir``."""

    def __init__(self, profile_dir: str, device: torch.device, rank: int):
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)
        activities = [ProfilerActivity.CPU]
        self.on_card = device.type == "cuda"
        if self.on_card:
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError(NO_CUPTI)
            activities.append(ProfilerActivity.CUDA)
        self.profile_dir, self.rank, self.span = profile_dir, rank, None
        self.prof = profile(activities=activities)
        self.prof.start()

    def begin_epoch(self, epoch: int) -> None:
        self.span = torch.profiler.record_function(f"epoch {epoch}")
        self.span.__enter__()

    def end_epoch(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def close(self, ran: bool) -> str:
        """Stop, write the trace (:func:`trace_path`) and return its path.
        After epochs that ran on a card (``ran``), raise if the trace holds
        none of the card's events."""
        self.end_epoch()
        self.prof.stop()
        path = trace_path(self.profile_dir, self.rank)
        self.prof.export_chrome_trace(path)
        log.info(f"    Profiler trace of the epochs written to {path}.")
        if ran and self.on_card:
            from torch.autograd import DeviceType
            if not any(e.device_type == DeviceType.CUDA
                       for e in self.prof.events()):
                raise RuntimeError(f"{NO_CUPTI} ({path} holds no event of "
                                   "the card)")
        return path


class NeuralAdmixtureTrainer:
    """Init -> epochs -> Q pass -> results, on ``cfg.device``, or, with
    ``grid`` (a parallel.grid.Grid), as this rank's part of a run over a
    grid of ranks, on the rank's device."""

    def __init__(self, cfg: TrainConfig, grid: Optional[Grid] = None):
        setup_logging()
        self.cfg = cfg
        self.grid = grid
        self.ks = sorted(cfg.ks)
        self.logged_losses: Dict[int, float] = {}
        self.epoch_seconds: List[float] = []
        self.train_seconds = 0.0
        # Host-clock seconds of launch_training's phases around the epochs:
        # layout (pre-shuffle, padding, missing scan, rows to the device),
        # init (parameters, optimizer, a resumed checkpoint), q_pass,
        # results (to numpy, Fst); and of the last checkpoint save and the
        # load. Layout = layout.host (up to the rows' upload) +
        # layout.upload (absent when nothing is uploaded); init =
        # init.params (a resumed checkpoint's load too) + init.optimizer.
        self.phase_seconds: Dict[str, float] = {}
        # On a grid whose profile is on (Grid.start_profile): each epoch's
        # parallel.grid.GridProfile.
        self.epoch_profiles: List = []
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
                        pops: Optional[np.ndarray] = None,
                        host_rows: Optional[Tuple[int, int]] = None
                        ) -> Tuple[List[np.ndarray], List[np.ndarray], Dict]:
        """Train and return (Qs, Ps, params): Q (N, k) in input row order
        and P (M, k) per K ascending, and the trained parameter dict (numpy,
        the JAX package's layout, V and P padded to m_pad).

        P_init: (sum(ks), M) initial P rows; packed: (N, W) uint8 host rows;
        V: (D, M) from the RSVD; ``pops``: (N,) integer labels in 0..K-1 in
        input row order, which turn on supervised mode. ``init_params``:
        the initial parameter dict (decoders included) instead of building
        one from V, P_init and draws; ``plans``: epoch -> (idx_full,
        idx_rem) instead of drawing them.

        On a grid, ``packed`` holds this data row's input rows, ``host_rows``
        = (start, end) of :meth:`sample_shard` (checked when given), at full
        width; everything else is global, and every rank returns the whole
        results."""
        cfg = self.cfg
        grid = self.grid
        device = grid.device if grid is not None else torch.device(cfg.device)
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

        # The data axis of the geometry (d_sz) and the processes of the
        # per-process pre-shuffle (ep; 0: one global pre-shuffle).
        emul = emulated_shards()
        if grid is not None:
            self._pick_mesh(m_pad, grid.n_data * grid.n_snp, device)
            d_sz = grid.n_data
            ep = d_sz if blk > 1 and d_sz > 1 else 0
        elif emul is not None:
            ep, d_sz = (emul if blk > 1 else (0, emul[1]))
        else:
            ep, d_sz = 0, 1
        b_round, nb, b_rem, n_rows = block_geometry(N, batch_size, blk, d_sz)

        # Layout: the one-time row pre-shuffle for block sampling, then zero
        # rows up to whole blocks of whole batches; resident on the device,
        # or, streamed, only the map from resident rows to host rows (on a
        # grid: the rank's block in host memory).
        t_phase = time.perf_counter()
        self._row_order = None
        if blk > 1:
            self._row_order = (
                shard_row_order(N, cfg.seed, ep, rows_per_process(
                    N, d_sz, ep, shard_quantum(d_sz, blk))) if ep
                else np.random.default_rng(cfg.seed).permutation(N))
        host, stream, self.stager, upload = None, False, None, None
        if grid is not None:
            rows_pp, host, upload, no_missing = self._grid_layout(
                packed, N, m_pad, b_round, host_rows, device)
            stream = host is not None
            n_rows = grid.n_data * rows_pp
            m_loc = m_pad // grid.n_snp
            col_mask = (torch.arange(grid.s * m_loc, (grid.s + 1) * m_loc,
                                     device=device) < M).to(torch.float32)
        else:
            stream = self._capacity_policy(
                n_rows * W, cfg.batch_size * m_pad // 4,
                self._plane_state_bytes(m_pad), device)
            host = np.ascontiguousarray(packed[:N])
            no_missing = not packed_has_missing(host)
            if stream:
                self._host_row = np.concatenate([
                    np.arange(N) if self._row_order is None
                    else self._row_order,
                    np.full(n_rows - N, -1)]).astype(np.int64)
                self.stager = HostStager(device, max(b_round,
                                                     min(N, INFER_BATCH)), W)
            else:
                data = (host if self._row_order is None
                        else host[self._row_order])
                if n_rows > N:
                    data = np.concatenate(
                        [data, np.zeros((n_rows - N, W), data.dtype)])
                upload = np.ascontiguousarray(data)
                del data
            col_mask = (torch.arange(m_pad, device=device) < M).to(
                torch.float32)
        resident, t_upload = None, None
        if upload is not None:
            t_upload = self._lap("layout.host", t_phase, device)
            resident = torch.from_numpy(upload).to(device)
            del upload
        pops_dev = self._prepare_pops(pops, N, device) if supervised else None
        strat = self._stratified_parts(stream, blk, emul)
        now = self._lap("layout", t_phase, device)
        if t_upload is None:
            self.phase_seconds["layout.host"] = now - t_phase
        else:
            self.phase_seconds["layout.upload"] = now - t_upload
        t_phase = now

        if init_params is None:
            init_params = qp.init_params(generator(cfg.seed, 0), V.T, P_init,
                                         cfg.hidden_size, self.ks, m_pad)
        if grid is not None:
            init_params = shard_params(init_params, grid.n_snp, grid.s)
        model = qp.params_from_numpy(init_params, self.ks, device)
        t_opt = self._lap("init.params", t_phase, device)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                               betas=(0.9, 0.95), eps=1e-8)
        t_opt_end = self._lap("init.optimizer", t_opt, device)
        if plans is None:
            def plans(epoch):
                if strat:
                    return stratified_plan(
                        lambda p, n: torch.randperm(n, generator=generator(
                            cfg.seed, 1, epoch, p)).numpy(),
                        strat, blk, N, n_rows, b_round, nb, b_rem)
                return epoch_plan(generator(cfg.seed, 1, epoch), N,
                                  batch_size, blk, n_rows, d_sz)
        start_epoch = 0
        if cfg.resume and cfg.checkpoint_path:
            start_epoch = self._load_checkpoint(model, opt)
        now = self._lap("init", t_phase, device)
        self.phase_seconds["init.params"] += now - t_opt_end
        t_phase = now

        log.info("")
        log.info("    Starting training...")
        log.info("")
        if start_epoch:
            log.info(f"    Resuming from epoch {start_epoch}.")
        # Padding rows reach a full batch under the stratified plan, and
        # per-row sampling widens full batches to the data axis.
        full_real, indexed, merged = program_choices(
            blk, stream, grid is not None,
            strat == 0 and (blk > 1 or b_round == batch_size))
        if grid is None:
            steps = self._batches(plans, start_epoch, N, n_rows, blk, host,
                                  resident, indexed, device)

            def step_fn(full, rows, xb, blk_idx, logged):
                with span("forward"):
                    row_w = (torch.ones(rows.shape[0], device=device)
                             if blk_idx is not None
                             else (rows < N).to(torch.float32))
                    loss, qs = fused_training_loss(
                        model, xb, col_mask, row_w, not (full and full_real),
                        no_missing, logged, merged, blk_idx, blk)
                    if supervised:
                        pops_b = pops_dev[torch.clamp(rows, max=N - 1)]
                        loss = loss + cfg.supervised_loss_weight * \
                            softmax_cross_entropy_sum(
                                qs[smallest_head(qs)], pops_b, row_w)
                with span("backward"):
                    loss.backward()
                return loss
        else:
            steps = self._grid_batches(plans, start_epoch, N, rows_pp, blk,
                                       host, resident, device)
            lag = make_sharded_loss_and_grad(grid, supervised,
                                             cfg.supervised_loss_weight)

            def step_fn(full, rows, xb, blk_idx, logged):
                # lag opens the na.forward and na.backward spans.
                return lag(model, xb, (rows < N).to(torch.float32), col_mask,
                           pops_dev[torch.clamp(rows, max=N - 1)]
                           if supervised else None,
                           not (full and full_real), no_missing, logged,
                           merged)
        try:  # the stager's pinned slots go on every way out, 143 too
            self._run_epochs(model, opt, start_epoch, steps, step_fn, N,
                             supervised, device)
            t_phase = time.perf_counter()
            with torch.no_grad():
                if grid is None:
                    qs = chunked_forward(
                        lambda b: model(b, no_missing),
                        host if stream else resident, N, min(N, INFER_BATCH),
                        device, order=self._row_order, stager=self.stager)
                else:
                    qs = infer_q_sharded(
                        model, grid, host if stream else resident,
                        min(rows_pp, max(0, N - grid.d * rows_pp)),
                        INFER_BATCH, no_missing, stager=self.stager)
        finally:
            if self.stager is not None:
                self.stager.close()
        Qs = [qs[f"k{k}"] for k in self.ks]
        if self._row_order is not None:
            Qs = [self._unshuffle_rows(q) for q in Qs]
        t_phase = self._lap("q_pass", t_phase, device)
        log.info("")
        log.info("    Training finished!")
        log.info("")
        params = to_host(model, grid)
        self.display_divergences(params, M)
        Ps = [params["decoders"][f"k{k}"].T[:M].astype(np.float32)
              for k in self.ks]
        self._lap("results", t_phase, device)
        return Qs, Ps, params

    def _grid_layout(self, packed: np.ndarray, N: int, m_pad: int,
                     b_round: int, host_rows, device):
        """This rank's block: its data row's rows (through the per-process
        pre-shuffle under block sampling), zero-padded to rows_per_process,
        its SNP block of them. By the capacity policy (the same decision on
        every rank: reckoned from rows_per_process) it stays in host memory,
        streamed through the rank's stager, or is to go to the device with
        one zero row appended (the padding rows of a batch read it). Returns
        (rows_pp, the streamed host block or None, the block to upload or
        None, no_missing over the whole grid)."""
        grid = self.grid
        start, end, rows_pp = self.sample_shard(m_pad, N)
        if host_rows is not None and tuple(host_rows) != (start, end):
            raise ValueError(
                f"launch_training got rows {tuple(host_rows)} but data row "
                f"{grid.d} owns [{start}, {end}); read the data with "
                "NeuralAdmixtureTrainer.sample_shard")
        n_local = end - start
        if packed.shape[0] < n_local:
            raise ValueError(f"packed holds {packed.shape[0]} rows; data row "
                             f"{grid.d} owns {n_local}")
        w_loc = m_pad // 4 // grid.n_snp
        stream = self._capacity_policy(
            rows_pp * w_loc, b_round // grid.n_data * w_loc,
            self._plane_state_bytes(m_pad) // grid.n_snp, device)
        cols = slice(grid.s * w_loc, (grid.s + 1) * w_loc)
        local = np.asarray(packed)[:n_local, cols]
        if self._row_order is not None:
            local = local[self._row_order[start:end] - start]
        block = np.zeros((rows_pp + (0 if stream else 1), w_loc), np.uint8)
        block[:n_local] = local
        # The kernels' no-missing variant only where no rank's block has a
        # code 3 (a batch holds rows of every data row).
        missing = torch.tensor([int(packed_has_missing(block))],
                               device=grid.comm_device)
        grid.psum_(missing, (DATA_AXIS, SNP_AXIS), "has_missing")
        no_missing = int(missing.item()) == 0
        if stream:
            self.stager = HostStager(
                device, max(b_round // grid.n_data, min(rows_pp, INFER_BATCH)),
                w_loc, gather_threads=grid.gather_threads)
            return rows_pp, block, None, no_missing
        return rows_pp, None, block, no_missing

    def _stratified_parts(self, stream: bool, blk: int, emul) -> int:
        """The partitions of the stratified plan (0: the global plan): the
        data rows of a grid that streams, or, under NA_TPU_STRATIFIED=1, of
        any grid or of an emulated layout under block sampling (the JAX
        package's rule, engine.py:1124-1140, a data row for a process)."""
        grid = self.grid
        parts = (grid.n_data if grid is not None
                 else emul[0] if emul is not None and blk > 1 else 0)
        if parts > 1 and ((stream and grid is not None) or
                          os.environ.get("NA_TPU_STRATIFIED") == "1"):
            return parts
        return 0

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
                with span("plan"):
                    # The plan goes to the device once per epoch: a pageable
                    # copy per step would wait for the previous step's
                    # kernels.
                    idx_full, idx_rem = (
                        torch.from_numpy(np.array(a, dtype=np.int64)).to(
                            device) for a in plan(epoch))
                    blk_ids = idx_full.to(torch.int32) if indexed else None
                for i in range(len(idx_full) + 1):
                    with span("batch"):
                        full = i < len(idx_full)
                        rows = batch_rows(idx_full[i] if full else idx_rem,
                                          blk)
                        ids = None
                        if staged is not None:
                            xb = next(staged)
                        elif indexed and full:
                            # Read in place: all rows real (full_real), no
                            # copy.
                            xb, ids = resident, blk_ids[i]
                        else:
                            xb = resident.index_select(
                                0, torch.clamp(rows, max=n_rows - 1))
                    yield epoch, full, rows, xb, ids
        finally:
            if staged is not None:
                staged.close()

    def _grid_epoch(self, plan: Plan, N: int, rows_pp: int, blk: int,
                    zero_row: int) -> List[Tuple]:
        """An epoch's steps for this rank, as (rows, local, exchange): the
        global resident ids of its data row's slice of the batch; when every
        slice's rows are its own data row's (on every rank alike), the rows
        of its block that the slice reads (exchange None); else, for the
        all_to_all over the data group, local None and exchange = (the rows
        its block sends, in data-row order, the slice's positions that
        receive, the counts received and sent per data row). A padding row
        (id >= N) is read as ``zero_row`` of the block of the data row whose
        slice holds it."""
        grid = self.grid
        D, d = grid.n_data, grid.d
        out = []
        for idx in list(plan[0]) + [plan[1]]:
            idx = np.asarray(idx, np.int64)
            rows = (idx[:, None] * blk + np.arange(blk)).reshape(-1) \
                if blk > 1 else idx
            pad = rows >= N
            # The data row that holds each position's row, per data row's
            # slice of the batch.
            slot = np.repeat(np.arange(D), len(rows) // D)
            owner = np.where(pad, slot, rows // rows_pp).reshape(D, -1)
            local = np.where(pad, zero_row, rows % rows_pp).reshape(D, -1)
            mine = rows.reshape(D, -1)[d]
            if (owner == np.arange(D)[:, None]).all():
                out.append((mine, local[d], None))
                continue
            send = [local[q][owner[q] == d] for q in range(D)]
            recv = [np.nonzero(owner[d] == p)[0] for p in range(D)]
            out.append((mine, None, (np.concatenate(send),
                                     np.concatenate(recv),
                                     [len(a) for a in recv],
                                     [len(a) for a in send])))
        return out

    def _grid_batches(self, plans, start_epoch: int, N: int, rows_pp: int,
                      blk: int, host: Optional[np.ndarray],
                      resident: Optional[torch.Tensor], device
                      ) -> Iterator[Tuple]:
        """Every step of a grid rank from ``start_epoch`` on, as
        :meth:`_batches` yields them: the global resident ids of its data
        row's slice of the batch, and the slice's packed rows of its SNP
        block. Resident: from its device block and, for rows held by other
        data rows, over the data group (:meth:`_grid_epoch`; an epoch's
        indices go to the device at once). Streamed (``host``): every row
        must be its own data row's (the stratified plan), and the slice is
        gathered from the host block through the stager, pipelined across
        epochs."""
        cfg = self.cfg
        memo: Dict[int, List[Tuple]] = {}

        def steps(epoch):
            if epoch not in memo:
                memo.clear()
                memo[epoch] = self._grid_epoch(
                    plans(epoch), N, rows_pp, blk,
                    -1 if host is not None else rows_pp)
            return memo[epoch]

        def host_jobs():
            for epoch in range(start_epoch, cfg.epochs):
                for _, local, exchange in steps(epoch):
                    if exchange is not None:
                        raise RuntimeError(
                            "a streamed grid step needs rows of another data "
                            "row; streaming needs the stratified plan")
                    yield local

        staged = (self.stager.batches(host, host_jobs())
                  if host is not None else None)
        try:
            for epoch in range(start_epoch, cfg.epochs):
                with span("plan"):
                    epoch_steps = steps(epoch)
                    parts = []
                    for rows, local, exchange in epoch_steps:
                        parts.append(rows)
                        if staged is None:
                            parts += [local] if exchange is None \
                                else list(exchange[:2])
                    flat = torch.from_numpy(np.concatenate(parts)).to(device)
                    views = iter(flat.split([len(a) for a in parts]))
                last = len(epoch_steps) - 1
                for i, (_, _, exchange) in enumerate(epoch_steps):
                    with span("batch"):
                        rows = next(views)
                        if staged is not None:
                            xb = next(staged)
                        elif exchange is None:
                            xb = resident.index_select(0, next(views))
                        else:
                            send_buf = resident.index_select(0, next(views))
                            recv_pos = next(views)
                            out = torch.empty(len(recv_pos),
                                              resident.shape[1],
                                              dtype=torch.uint8,
                                              device=device)
                            self.grid.all_to_all_rows(
                                out, send_buf, exchange[2], exchange[3],
                                "exchange")
                            xb = torch.empty_like(out).index_copy_(
                                0, recv_pos, out)
                    yield epoch, i < last, rows, xb, None
        finally:
            if staged is not None:
                staged.close()

    def _run_epochs(self, model, opt, start_epoch: int, steps, step_fn,
                    N: int, supervised: bool, device) -> None:
        """The epoch loop from ``start_epoch`` over ``steps`` (what
        :meth:`_batches` or :meth:`_grid_batches` yields), each step's loss
        and gradients from ``step_fn(full, rows, xb, blk_idx, logged)``: the
        optimizer steps, the logged losses, the periodic checkpoints and
        the SIGTERM save (the JAX package's _run_epochs,
        engine.py:1298-1445)."""
        cfg = self.cfg
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

        # Per-run state: a trainer may run again (--init_restarts).
        self.logged_losses, self.epoch_seconds = {}, []
        self.epoch_profiles = []
        grid = self.grid
        trace = (EpochTrace(cfg.profile_dir, device,
                            grid.rank if grid is not None else 0)
                 if cfg.profile_dir else None)
        _sync(device)
        t_train = t_epoch = time.perf_counter()
        loss_sum = None
        try:
            if trace is not None:
                trace.begin_epoch(start_epoch)
            with closing(steps):
                for epoch, full, rows, xb, blk_idx in steps:
                    logged = epoch % log_every == 0
                    # step_fn opens na.forward and na.backward.
                    loss = step_fn(full, rows, xb, blk_idx, logged)
                    with span("adam"):
                        opt.step()
                        opt.zero_grad(set_to_none=True)
                    with span("clamp"):
                        model.restrict_P()
                        if logged:
                            loss = loss.detach()
                            loss_sum = loss if loss_sum is None else \
                                loss_sum + loss
                    if full:
                        continue
                    # The epoch's last step.
                    with span("epoch_end"):
                        self._end_epoch(epoch, logged, loss_sum, t_epoch,
                                        model, opt, ckpt_on, device)
                        loss_sum = None
                    if trace is not None:
                        trace.end_epoch()
                        if epoch + 1 < cfg.epochs:
                            trace.begin_epoch(epoch + 1)
                    t_epoch = time.perf_counter()
        except BaseException:
            # An exception, SIGTERM's exit 143 too, leaves no trace running
            # and writes what it recorded.
            if trace is not None:
                trace.close(ran=False)
                trace = None
            raise
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_sigterm
                              if prev_sigterm is not None else signal.SIG_DFL)
        if trace is not None:
            trace.close(ran=start_epoch < cfg.epochs)
        if cfg.progress and start_epoch < cfg.epochs:
            print(file=sys.stderr)
        self.train_seconds = time.perf_counter() - t_train
        epochs_run = cfg.epochs - start_epoch
        if epochs_run > 0 and self.train_seconds > 0:
            log.info(f"    Training throughput: "
                     f"{N * epochs_run / self.train_seconds:,.0f} samples/s "
                     f"({self.train_seconds:.2f}s for {epochs_run} epochs).")

    def _end_epoch(self, epoch: int, logged: bool, loss_sum, t_epoch: float,
                   model, opt, ckpt_on: bool, device) -> None:
        """After an epoch's last step: its logged loss read back and logged,
        the synchronise that closes ``epoch_seconds``, the grid's profile,
        progress, the periodic checkpoint, and on SIGTERM the save and exit
        143."""
        cfg, grid = self.cfg, self.grid
        if logged:
            self.logged_losses[epoch] = float(loss_sum)
            log.info(f"            Loss in epoch {epoch:3d} is "
                     f"{self.logged_losses[epoch]:,.0f}")
        _sync(device)
        self.epoch_seconds.append(time.perf_counter() - t_epoch)
        if grid is not None and grid.profile is not None:
            self.epoch_profiles.append(grid.lap_profile())
        if cfg.progress:
            print(f"\r    Epochs: {epoch + 1}/{cfg.epochs}", end="",
                  file=sys.stderr, flush=True)
        saved = ckpt_on and (epoch + 1) % cfg.checkpoint_every == 0
        if saved:
            self._save_checkpoint(epoch + 1, model, opt)
        preempted = self._preempted
        if ckpt_on and grid is not None:
            # Every rank stops at the epoch where any rank was signalled
            # (the signal may reach hosts apart).
            flag = torch.tensor([int(preempted)], device=grid.comm_device)
            preempted = bool(grid.psum_(flag, (DATA_AXIS, SNP_AXIS),
                                        "preempt").item())
        if preempted and epoch + 1 < cfg.epochs:
            if not saved:
                self._save_checkpoint(epoch + 1, model, opt)
            if grid is not None:
                # No rank leaves before the file is written.
                grid.psum_(torch.zeros(1, device=grid.comm_device),
                           (DATA_AXIS, SNP_AXIS), "saved")
            if cfg.progress:
                print(file=sys.stderr)
            log.info(f"    SIGTERM received: resumable checkpoint saved at "
                     f"epoch {epoch + 1} ({cfg.checkpoint_path}); exiting. "
                     "Restart with --resume to continue.")
            raise SystemExit(PREEMPTED_EXIT)
        if grid is not None and grid.profile is not None:
            # An epoch's profile holds its steps: the save's gathers and
            # write are measured apart.
            grid.start_profile()

    def _capacity_policy(self, data_bytes: int, batch_bytes: int,
                         plane_bytes: int, device) -> bool:
        """Resident or host-streamed training (sets ``self._streamed``), by
        the JAX package's estimate for its kernels (engine.py:1085-1160),
        which decode in registers: no f32 unpack transient. Per device: the
        resident packed rows, one packed batch and the SNP-plane state
        (:meth:`_plane_state_bytes`; on a grid, each rank's block of each)
        against HBM_BUDGET_FRAC of the capacity; streamed, the same without
        the resident rows."""
        cfg = self.cfg
        cap_gb = hbm_capacity_bytes(device) / 2**30
        per_chip = data_bytes + batch_bytes + plane_bytes
        per_chip_stream = batch_bytes + plane_bytes
        budget = HBM_BUDGET_FRAC * cap_gb * 2**30
        resident_fits = per_chip <= budget
        stream = cfg.stream
        if stream is None:
            stream = not resident_fits and per_chip_stream <= budget
        self._streamed = bool(stream)
        if stream:
            log.info(
                f"    Host-streaming (out-of-core) training: packed "
                f"genotypes ({data_bytes / 2**30:.1f} GiB"
                + (" per rank" if self.grid is not None else "")
                + ") stay in host memory; estimated per-chip HBM need "
                f"drops to ~{per_chip_stream / 2**30:.1f} GiB.")
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

    def _auto_snp_axis(self, n_dev: int, m_pad: int, device=None) -> int:
        """The auto grid policy (the JAX package's _auto_snp_axis,
        engine.py:1559-1578): ranks go to the snp axis, doubling it, only
        while the SNP-plane state plus a batch's packed scratch exceeds the
        per-device budget; otherwise all data-parallel (fewer collectives).
        The budget is NA_TPU_HBM_BUDGET_GB, or half the device's capacity
        (utils/hbm.py: the card's memory), where the JAX package's default
        is 8 GiB, half of a v5e's 16."""
        env = os.environ.get("NA_TPU_HBM_BUDGET_GB")
        budget = (float(env) * 2**30 if env
                  else hbm_capacity_bytes(device) / 2)
        plane_bytes = self._plane_state_bytes(m_pad) \
            + self.cfg.batch_size * m_pad
        n_snp = 1
        while (plane_bytes / n_snp > budget and n_snp < n_dev
               and n_dev % (n_snp * 2) == 0
               and m_pad % (n_snp * 2 * SNP_QUANTUM) == 0):
            n_snp *= 2
        return n_snp

    def _pick_mesh(self, m_pad: int, n_dev: int, device=None
                   ) -> Tuple[int, int]:
        """The grid (n_data, n_snp) over ``n_dev`` ranks: cfg.mesh_shape, the
        trainer's grid, or the auto policy (the JAX package's _pick_mesh,
        engine.py:1601-1630). Raises where a rank's SNP block would not be
        whole 32-bit words of every packed row."""
        shape = self.cfg.mesh_shape or (self.grid.shape if self.grid
                                        else None)
        if shape is None:
            n_snp = (self._auto_snp_axis(n_dev, m_pad, device)
                     if n_dev > 1 else 1)
            shape = (n_dev // n_snp, n_snp)
        n_data, n_snp = (int(v) for v in shape)
        check_snp_axis(m_pad, n_snp)
        if self.grid is not None and (n_data, n_snp) != self.grid.shape:
            raise ValueError(f"mesh_shape {(n_data, n_snp)} but the grid is "
                             f"{self.grid.shape}")
        return n_data, n_snp

    def data_axis_size(self) -> int:
        """Data rows of the grid (1 without one)."""
        return self.grid.n_data if self.grid is not None else 1

    def sample_shard(self, m_pad: int, N: int) -> Tuple[int, int, int]:
        """This data row's input rows (start, end, rows_per_process), with
        the block-sampling row quantum (resident rows must tile exactly into
        whole batches of whole blocks): what the input pipeline reads, and
        what launch_training's layout assumes. ``m_pad`` is checked against
        the grid."""
        if self.grid is not None:
            self._pick_mesh(m_pad, self.grid.n_data * self.grid.n_snp)
        blk = max(1, self.cfg.sample_block)
        D = self.data_axis_size()
        q = shard_quantum(D, blk) if blk > 1 else 1
        return host_sample_shard(N, D, q, self.grid.d if self.grid else 0, D)

    def _ckpt_meta(self) -> Dict:
        """The hyperparameters that must match between save and resume (the
        JAX package's _ckpt_meta): a restored Adam state stepped through
        another objective diverges silently. ``mesh_shape`` (the grid's
        (n_data, n_snp), [1, 1] on one device) is recorded, not compared:
        a resume may change it."""
        cfg = self.cfg
        return {
            "mesh_shape": list(self.grid.shape if self.grid is not None
                               else (1, 1)),
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
        and ``step``, as plain arrays. On a grid the file is the same, at
        full width: data row 0's ranks gather V, the Ps and their moments
        over their snp group, and rank 0 writes."""
        t = time.perf_counter()
        grid = self.grid
        if grid is not None and grid.d != 0:
            return
        groups = {key: {} for key in CKPT_GROUPS}
        steps = {}
        for name, p, transpose in qp.param_layout(model):
            groups["param"][name] = qp.to_layout(p, transpose)
            state = opt.state.get(p)
            if state:
                for key in CKPT_GROUPS[1:]:
                    groups[key][name] = qp.to_layout(state[key], transpose)
                steps[name] = np.int64(int(state["step"]))
        groups = {key: _flatten(gather_snp(_unflatten(g), grid,
                                           f"ckpt_{key}"))
                  for key, g in groups.items()}
        if grid is not None and grid.rank != 0:
            return
        arrays = {"format": np.bytes_(CKPT_FORMAT.encode()),
                  "epoch": np.int64(epoch),
                  "meta": np.bytes_(json.dumps(self._ckpt_meta()).encode())}
        arrays.update({_ckpt_key(key, name): a for key, g in groups.items()
                       for name, a in g.items()})
        arrays.update({_ckpt_key("step", name): n
                       for name, n in steps.items()})
        path = self.cfg.checkpoint_path
        tmp = f"{path}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        self.phase_seconds["save"] = time.perf_counter() - t

    def _read_checkpoint(self, path: str):
        """(epoch, {group: {layout name: array}} of CKPT_GROUPS, {layout
        name: Adam's step}) of ``path``, at full width; refuses a file of
        another layout and any hyperparameter change."""
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
            saved_mesh = saved.pop("mesh_shape", None)
            now_mesh = now.pop("mesh_shape")
            # Keys absent from the file (an older one) are not compared.
            diffs = {k: (saved[k], now[k]) for k in now
                     if k in saved and saved[k] != now[k]}
            if diffs:
                raise ValueError(
                    "Checkpoint hyperparameters do not match this run; "
                    "refusing to resume. Mismatches (checkpoint vs now): "
                    + ", ".join(f"{k}: {a} vs {b}"
                                for k, (a, b) in sorted(diffs.items())))
            if saved_mesh is not None and list(saved_mesh) != now_mesh:
                log.info(f"    Checkpoint was trained on mesh "
                         f"{tuple(saved_mesh)}; resharding onto "
                         f"{tuple(now_mesh)} on resume.")
            names = [n[len("param/"):] for n in data.files
                     if n.startswith("param/")]
            steps = {n: int(data[_ckpt_key("step", n)]) for n in names
                     if _ckpt_key("step", n) in data.files}
            groups = {key: {n: data[_ckpt_key(key, n)] for n in names
                            if key == "param" or n in steps}
                      for key in CKPT_GROUPS}
            return int(data["epoch"]), groups, steps

    def _load_checkpoint(self, model, opt) -> int:
        """Restore ``cfg.checkpoint_path`` into the model and the optimizer
        and return its next epoch; 0 (start fresh) when there is no file.
        On a grid every rank reads the file and cuts its SNP block of V, the
        Ps and their moments; the ranks first agree that each found the
        same file at the same epoch, or every rank raises: none trains from
        a start the others do not share."""
        path = self.cfg.checkpoint_path
        grid = self.grid
        t = time.perf_counter()
        found, error = None, None
        if os.path.exists(path):
            try:
                found = self._read_checkpoint(path)
            except (OSError, ValueError, KeyError) as exc:
                error = exc
        if grid is not None:
            # (read failed, file found, its epoch) of every rank.
            mine = torch.tensor(
                [int(error is not None), int(found is not None),
                 found[0] if found is not None else -1],
                dtype=torch.int64, device=grid.comm_device)
            views = torch.stack(grid.all_gather(
                mine, (DATA_AXIS, SNP_AXIS), "ckpt_agree")).cpu().numpy()
            seen = {tuple(v) for v in views[:, 1:].tolist()}
            if error is None and views[:, 0].any():
                error = RuntimeError(
                    f"ranks {np.nonzero(views[:, 0])[0].tolist()} could not "
                    f"read the checkpoint {path}; refusing to resume.")
            if error is None and len(seen) > 1:
                error = RuntimeError(
                    f"the ranks do not see one checkpoint at {path} (found, "
                    f"epoch per rank: {views[:, 1:].tolist()}); save_dir "
                    "must be a path every host sees. Refusing to resume.")
        if error is not None:
            raise error
        if found is None:
            return 0
        epoch, groups, steps = found
        if grid is not None:
            groups = {key: _flatten(shard_params(_unflatten(g), grid.n_snp,
                                                 grid.s))
                      for key, g in groups.items()}
        layout = qp.param_layout(model)
        with torch.no_grad():
            for name, p, transpose in layout:
                p.copy_(qp.from_layout(groups["param"][name], transpose))
        index = {id(p): i for i, p in enumerate(opt.param_groups[0]["params"])}
        state = {index[id(p)]: {
            "step": torch.tensor(float(steps[name])),
            **{key: qp.from_layout(groups[key][name], transpose)
               for key in CKPT_GROUPS[1:]}}
            for name, p, transpose in layout if name in steps}
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
