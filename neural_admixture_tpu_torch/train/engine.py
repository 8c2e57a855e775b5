"""The training engine: one device, data resident on it.

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
  * The packed rows, V, P and the Adam state stay on the device; a batch is
    gathered there from the resident (n_rows, W) uint8 tensor, block by
    block, and goes through ops/fused_step.py (kernels K2-K6).
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
    arithmetic.
  * The encoder init and the per-epoch batch plans come from CPU generators
    seeded from ``seed`` (utils/seeding.py), so a run on the card and a run
    on the CPU draw identical plans and initial weights. ``launch_training``
    also takes both from the caller (the tests hand in the JAX package's).

Left for later slices (ROADMAP.md Queue 1): checkpoints (item 9), host
streaming (10), several devices (12).
"""
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import qp
from ..ops.fused_step import fused_training_loss
from ..ops.loss import softmax_cross_entropy_sum
from ..ops.pack import batch_rows, packed_has_missing
from ..utils.logger import log, setup_logging
from ..utils.metrics import fst_table
from ..utils.seeding import generator
from .chunked import chunked_forward

INFER_BATCH = 1024

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


def program_choices(blk: int) -> Tuple[bool, bool, bool]:
    """(full_real, indexed, merged) from the JAX package's environment
    variables (see the module docstring): full batches run unmasked unless
    NA_TPU_FORCE_MASKED=1; they are indexed under NA_TPU_INDEXED=1 when
    they are unmasked whole blocks; logged epochs run merged (K4) unless
    NA_TPU_SPLIT_LOSS=1."""
    full_real = os.environ.get("NA_TPU_FORCE_MASKED") != "1"
    indexed = (full_real and blk > 1
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
        # init (parameters, optimizer), q_pass, results (to numpy, Fst).
        self.phase_seconds: Dict[str, float] = {}

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
        m_pad = packed.shape[1] * 4
        full_real, indexed, merged = program_choices(blk)
        supervised = pops is not None
        log_every = 2 if supervised else cfg.log_every

        # Resident layout: the one-time row pre-shuffle for block sampling,
        # then zero rows up to whole blocks of whole batches.
        t_phase = time.perf_counter()
        self._row_order = None
        data = packed[:N]
        if blk > 1:
            self._row_order = np.random.default_rng(cfg.seed).permutation(N)
            data = data[self._row_order]
        _, nb, _, n_rows = block_geometry(N, batch_size, blk)
        if n_rows > N:
            data = np.concatenate(
                [data, np.zeros((n_rows - N, data.shape[1]), data.dtype)])
        no_missing = not packed_has_missing(data)
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
        t_phase = self._lap("init", t_phase, device)

        log.info("")
        log.info("    Starting training...")
        log.info("")
        self.logged_losses, self.epoch_seconds = {}, []
        _sync(device)
        t_train = time.perf_counter()
        for epoch in range(cfg.epochs):
            t_epoch = time.perf_counter()
            logged = epoch % log_every == 0
            # The plan goes to the device once per epoch: a pageable copy
            # per step would wait for the previous step's kernels.
            idx_full, idx_rem = (
                torch.from_numpy(np.array(a, dtype=np.int64)).to(device)
                for a in plans(epoch))
            blk_ids = idx_full.to(torch.int32) if indexed else None
            loss_sum = None
            for i in range(len(idx_full) + 1):
                full = i < len(idx_full)
                rows = batch_rows(idx_full[i] if full else idx_rem, blk)
                blk_idx = blk_ids[i] if indexed and full else None
                if blk_idx is not None:
                    # Read in place: all rows real (full_real), no copy.
                    xb, row_w = resident, torch.ones(rows.shape[0],
                                                     device=device)
                else:
                    row_w = (rows < N).to(torch.float32)
                    xb = resident.index_select(
                        0, torch.clamp(rows, max=n_rows - 1))
                opt.zero_grad(set_to_none=True)
                loss, qs = fused_training_loss(
                    model, xb, col_mask, row_w, not (full and full_real),
                    no_missing, logged, merged, blk_idx, blk)
                if supervised:
                    pops_b = pops_dev[torch.clamp(rows, max=N - 1)]
                    loss = loss + cfg.supervised_loss_weight * \
                        softmax_cross_entropy_sum(qs[smallest_head(qs)],
                                                  pops_b, row_w)
                loss.backward()
                opt.step()
                model.restrict_P()
                if logged:
                    loss = loss.detach()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
            if logged:
                self.logged_losses[epoch] = float(loss_sum)
                log.info(f"            Loss in epoch {epoch:3d} is "
                         f"{self.logged_losses[epoch]:,.0f}")
            _sync(device)
            self.epoch_seconds.append(time.perf_counter() - t_epoch)
            if cfg.progress:
                print(f"\r    Epochs: {epoch + 1}/{cfg.epochs}", end="",
                      file=sys.stderr, flush=True)
        if cfg.progress:
            print(file=sys.stderr)
        self.train_seconds = time.perf_counter() - t_train
        if cfg.epochs and self.train_seconds > 0:
            log.info(f"    Training throughput: "
                     f"{N * cfg.epochs / self.train_seconds:,.0f} samples/s "
                     f"({self.train_seconds:.2f}s for {cfg.epochs} epochs).")

        t_phase = time.perf_counter()
        Qs = self._infer_q(model, resident, N, no_missing, device)
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

    def _infer_q(self, model, resident: torch.Tensor, N: int,
                 no_missing: bool, device) -> List[np.ndarray]:
        """The full-data encoder pass over the resident rows, batch <=
        1024 (the xv kernel on the card)."""
        with torch.no_grad():
            qs = chunked_forward(lambda blk: model(blk, no_missing), resident,
                                 N, min(N, INFER_BATCH), device)
        return [qs[f"k{k}"] for k in self.ks]

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
