"""The training engine: one device, data resident on it.

The JAX package's train/engine.py on one device, with its semantics:
fixed-epoch Adam (betas (0.9, 0.95), eps 1e-8) over V, the encoder and
every P, P clamped to [0, 1] after every step, the summed BCE loss computed
and logged every ``log_every`` epochs only, then a full-data Q pass.

  * Batches: with ``sample_block`` > 1 the rows are pre-shuffled once
    (``np.random.default_rng(seed).permutation(N)``, undone on Q) and
    batches are runs of ``sample_block`` consecutive resident rows; an epoch
    is nb - 1 full batches of real rows (the unmasked kernels) and one
    remainder batch that carries the partial block and the padding (the
    masked kernels). ``sample_block`` = 1 samples single rows. Geometry with
    alignment 1 (the JAX package's XLA path, engine.py:176-244).
  * The packed rows, V, P and the Adam state stay on the device; a batch is
    gathered there from the resident (n_rows, W) uint8 tensor, block by
    block, and goes through ops/fused_step.py (kernels K2-K5).
  * The encoder init and the per-epoch batch plans come from CPU generators
    seeded from ``seed`` (utils/seeding.py), so a run on the card and a run
    on the CPU draw identical plans and initial weights. ``launch_training``
    also takes both from the caller (the tests hand in the JAX package's).

Left for later slices (ROADMAP.md Queue 1): multi-head and supervised
(item 8), checkpoints (9), host streaming (10), several devices (12).
"""
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import qp
from ..ops.fused_step import fused_training_loss
from ..ops.pack import packed_has_missing
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
    log_every: int = 5
    progress: bool = True
    sample_block: int = 1
    device: str = "cuda"


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
                        plans: Optional[Callable[[int], Plan]] = None
                        ) -> Tuple[List[np.ndarray], List[np.ndarray], Dict]:
        """Train and return (Qs, Ps, params): Q (N, k) in input row order
        and P (M, k) per K ascending, and the trained parameter dict (numpy,
        the JAX package's layout, V and P padded to m_pad).

        P_init: (sum(ks), M) initial P rows; packed: (N, W) uint8 host rows;
        V: (D, M) from the RSVD. ``init_params``: the initial parameter dict
        (decoders included) instead of building one from V, P_init and
        draws; ``plans``: epoch -> (idx_full, idx_rem) instead of drawing
        them."""
        cfg = self.cfg
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("training was asked for a CUDA device, but no "
                               "CUDA device is available.")
        torch.backends.cuda.matmul.allow_tf32 = False
        blk = max(1, cfg.sample_block)
        batch_size = min(cfg.batch_size, N)
        m_pad = packed.shape[1] * 4

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
        blk_ar = torch.arange(blk, device=device)
        self.logged_losses, self.epoch_seconds = {}, []
        _sync(device)
        t_train = time.perf_counter()
        for epoch in range(cfg.epochs):
            t_epoch = time.perf_counter()
            logged = epoch % cfg.log_every == 0
            # The plan goes to the device once per epoch: a pageable copy
            # per step would wait for the previous step's kernels.
            idx_full, idx_rem = (
                torch.from_numpy(np.array(a, dtype=np.int64)).to(device)
                for a in plans(epoch))
            batches = [(b, False) for b in idx_full] + [(idx_rem, True)]
            loss_sum = None
            for idx, masked in batches:
                rows = (idx[:, None] * blk + blk_ar).reshape(-1)
                row_w = (rows < N).to(torch.float32)
                xb = resident.index_select(0, torch.clamp(rows,
                                                          max=n_rows - 1))
                opt.zero_grad(set_to_none=True)
                loss, _ = fused_training_loss(model, xb, col_mask, row_w,
                                              masked, no_missing, logged)
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
