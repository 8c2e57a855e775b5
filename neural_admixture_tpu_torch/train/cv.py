"""K-fold cross-validation for choosing K (the JAX package's train/cv.py).

The classic ADMIXTURE workflow that the reference declares but ships
commented out: KFold(shuffle=True, random_state=seed) over the samples; per
fold, the port's RSVD and P init on the training rows, one multi-head model
trained on them (every K jointly), the held-out rows projected through the
trained encoder (``infer_q``, the same pass as ``infer``: the xv kernel on
the card), and per K

    cv_error(K) = -loglikelihood(G_val | P_K, Q_val) / n_val,

the per-sample negative validation log-likelihood (lower is better). The
errors are reduced to mean and std over the folds, logged as ``CV error
(K=k): mean ± std``, written to ``{name}.cv_errors.csv`` (and, with
matplotlib, plotted), and returned.

One process only: each fold re-slices the packed rows in host memory, one
copy of the fold's rows at a time. On a grid of ranks ``train`` refuses
``--cv``, as the JAX package refuses it across processes.
"""
import copy
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..infer import infer_q
from ..ops.loglikelihood import loglikelihood_packed
from ..ops.rsvd import resident_bytes, rsvd
from ..utils.hbm import should_stream_host
from ..utils.logger import log
from .engine import NeuralAdmixtureTrainer, TrainConfig
from .init import init_p_supervised_packed, init_p_unsupervised

__all__ = ["kfold_indices", "run_fold", "held_out_errors",
           "run_cross_validation", "report_cv"]


def kfold_indices(N: int, n_splits: int, seed: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, val_idx) per fold, as sklearn's KFold(n_splits,
    shuffle=True, random_state=seed) splits: a RandomState shuffle, then
    contiguous validation blocks, the first N % n_splits one larger."""
    if not 2 <= n_splits <= N:
        raise ValueError(
            f"--cv needs between 2 and N={N} folds, got {n_splits}.")
    idx = np.arange(N)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, N // n_splits, dtype=np.int64)
    sizes[: N % n_splits] += 1
    folds, start = [], 0
    for sz in sizes:
        val = idx[start:start + sz]
        train = np.concatenate([idx[:start], idx[start + sz:]])
        folds.append((np.sort(train), np.sort(val)))
        start += sz
    return folds


@dataclass
class Fold:
    """One fold's results: ``errors`` (cv_error per K, ascending), the
    trained ``Ps`` (M, k), the held-out ``q_val`` (n_val, k), and the host
    seconds of its parts: rsvd, init, train, project and ll."""
    errors: List[float]
    Ps: List[np.ndarray]
    q_val: List[np.ndarray]
    seconds: Dict[str, float]


def held_out_errors(packed_val: np.ndarray, M: int, Ps, q_val,
                    device=None) -> List[float]:
    """cv_error per K: -loglikelihood(G_val | P_k, Q_val) / n_val, the
    log-likelihood in float64 as ``train`` computes it."""
    n_val = packed_val.shape[0]
    return [-loglikelihood_packed(
        packed_val, M, np.ascontiguousarray(P.astype(np.float64)),
        np.ascontiguousarray(q.astype(np.float64)), device=device) / n_val
            for P, q in zip(Ps, q_val)]


def run_fold(packed_tr: np.ndarray, packed_val: np.ndarray, M: int,
             ks: List[int], seed: int, cfg: TrainConfig,
             pops_tr: Optional[np.ndarray] = None,
             V: Optional[np.ndarray] = None,
             P_init: Optional[np.ndarray] = None,
             init_params: Optional[Dict] = None,
             plans: Optional[Callable] = None) -> Fold:
    """Train on the fold's packed rows ``packed_tr`` (``pops_tr``: their
    labels in supervised mode) and score the held-out ``packed_val``, on
    ``cfg.device``. The RSVD and the P init run on the training rows,
    resident or streamed by ``cfg.stream`` (None: by the RSVD's estimate);
    the trainer gets a copy of ``cfg`` with progress, checkpoints and resume
    off. ``V``, ``P_init``, ``init_params`` and ``plans`` replace what the
    fold would compute or draw (tests hand in the JAX package's)."""
    device = torch.device(cfg.device)
    n_tr = packed_tr.shape[0]
    seconds: Dict[str, float] = {}
    t = time.perf_counter()
    if V is None or P_init is None:
        stream = cfg.stream if cfg.stream is not None else should_stream_host(
            resident_bytes(n_tr, packed_tr.shape[1], cfg.n_components),
            device=device)
        rows = packed_tr if stream else torch.from_numpy(packed_tr).to(device)
        if V is None:
            V = rsvd(rows, n_tr, M, cfg.n_components, seed, device=device,
                     stream=stream)
            now = time.perf_counter()
            seconds["rsvd"], t = now - t, now
        if P_init is None:
            P_init = (init_p_supervised_packed(rows, pops_tr, ks[0], M,
                                               device=device, stream=stream)
                      if pops_tr is not None else
                      init_p_unsupervised(rows, V, n_tr, M, ks, seed,
                                          device=device, stream=stream))
            now = time.perf_counter()
            seconds["init"], t = now - t, now
        del rows
    cfg_f = copy.deepcopy(cfg)
    cfg_f.progress, cfg_f.checkpoint_every, cfg_f.resume = False, 0, False
    _, Ps, params = NeuralAdmixtureTrainer(cfg_f).launch_training(
        P_init, packed_tr, V, M, n_tr, init_params=init_params, plans=plans,
        pops=pops_tr)
    now = time.perf_counter()
    seconds["train"], t = now - t, now
    q_val = infer_q(params, packed_val, packed_val.shape[0], ks,
                    device=device)
    now = time.perf_counter()
    seconds["project"], t = now - t, now
    errors = held_out_errors(packed_val, M, Ps, q_val, device)
    seconds["ll"] = time.perf_counter() - t
    return Fold(errors, Ps, q_val, seconds)


def run_cross_validation(packed: np.ndarray, N: int, M: int, ks: List[int],
                         n_splits: int, seed: int, trainer_cfg: TrainConfig,
                         name: str, save_dir: str,
                         pops: Optional[np.ndarray] = None,
                         fold: Callable[..., Fold] = run_fold
                         ) -> Dict[int, Tuple[float, float]]:
    """Run the folds over the (N, W) packed rows in host memory; returns
    {K: (cv_error_mean, cv_error_std)}. ``pops``: (N,) integer labels
    (supervised). ``fold``: the per-fold function, called as ``fold(
    packed_tr, packed_val, M, ks, seed, trainer_cfg, pops_tr)``."""
    log.info(f"    Performing {n_splits}-fold cross-validation...")
    errs: Dict[int, List[float]] = {k: [] for k in ks}
    for f, (tr_idx, val_idx) in enumerate(kfold_indices(N, n_splits, seed)):
        # One fold's copy of the rows at a time.
        packed_tr = np.ascontiguousarray(packed[tr_idx])
        packed_val = np.ascontiguousarray(packed[val_idx])
        res = fold(packed_tr, packed_val, M, ks, seed, trainer_cfg,
                   pops[tr_idx] if pops is not None else None)
        for k, e in zip(ks, res.errors):
            errs[k].append(e)
        del packed_tr, packed_val, res
        log.info(f"        Fold {f + 1}/{n_splits} done "
                 f"({tr_idx.size} train / {val_idx.size} validation "
                 "samples).")
    return report_cv(errs, ks, name, save_dir)


def report_cv(errs: Dict[int, List[float]], ks: List[int], name: str,
              save_dir: str) -> Dict[int, Tuple[float, float]]:
    """Reduce the per-fold errors to (mean, std) per K; log them, write
    ``{name}.cv_errors.csv`` and the plot, and log the K of the lowest."""
    out: Dict[int, Tuple[float, float]] = {}
    lines = ["K,cv_error_mean,cv_error_std"]
    for k in ks:
        mean = float(np.mean(errs[k]))
        std = float(np.std(errs[k]))
        out[k] = (mean, std)
        # The reference's dead code's format (src/main.py:76-77).
        log.info(f"CV error (K={k}): {mean:.5f} ± {std:.3f}")
        lines.append(f"{k},{mean:.6f},{std:.6f}")
    path = os.path.join(save_dir, f"{name}.cv_errors.csv")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    log.info(f"    CV errors written to {path}.")
    _save_cv_error_plot(out, ks, os.path.join(save_dir,
                                              f"{name}.cv_errors.png"))
    best = min(out, key=lambda k: out[k][0])
    log.info(f"    Lowest CV error at K={best}.")
    return out


def _save_cv_error_plot(out, ks, path: str) -> None:
    """The CV-error-against-K plot. Best effort: skipped with a single K,
    and, with a log line, without matplotlib."""
    if len(ks) < 2:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        means = [out[k][0] for k in ks]
        stds = [out[k][1] for k in ks]
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.errorbar(ks, means, yerr=stds, marker="o", capsize=3)
        ax.set_xlabel("K")
        ax.set_ylabel(
            "CV error (per-sample negative validation log-likelihood)")
        ax.set_xticks(list(ks))
        ax.set_title("Cross-validation error by K")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
    except Exception as e:  # noqa: BLE001 - an optional plot must never
        # end the run before the full-data fit (no matplotlib, a broken
        # backend or font cache, a read-only directory); the csv has the
        # numbers.
        log.info(f"    CV error plot skipped ({type(e).__name__}: {e}).")
        return
    log.info(f"    CV error plot written to {path}.")
