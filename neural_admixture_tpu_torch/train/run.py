"""Train mode: read -> pack -> RSVD -> init P -> train -> save.

The JAX package's train/run.py ``main_train`` for the ported slice: a
PLINK BED, a PGEN or a VCF, one K (``--k``) or a K range (``--min_k`` ..
``--max_k``, one head per K, trained jointly), unsupervised or supervised
(``--pops_path``, one K), with resumable checkpoints (``--checkpoint_every``,
``--resume``, SIGTERM) and host streaming (``--stream``), on one device or
over a grid of ranks, with K-fold cross-validation (``--cv``, one process;
train/cv.py), independently seeded restarts (``--init_restarts``, the best
kept by log-likelihood) and a profiler trace of the epochs
(``--profile_dir``). Resident, the packed rows go to the device once for
the RSVD and the P init and once more for training;
streamed (``--stream 1``, or ``auto`` when they do not fit), no phase
uploads the whole packed matrix: the RSVD, the PCA projection or the
supervised means, training, the Q pass and the log-likelihood read it block
by block through the stager (io/stage.py). The (N, M) genotype matrix never
exists.

A grid (``--num_gpus N > 1``, ``--mesh DxS``, or several hosts through the
NA_TPU_* variables; parallel/): each host starts its ranks, every rank of
data row d reads only that row's sample rows (the trainer's sample_shard),
the minor-allele flip follows the code counts of every data row, the RSVD
and the P init run on the data row's rows with their sketch, coordinates or
sums joined over the data group (streamed when the rank's own estimate
says so), training runs sharded, streamed or resident, with checkpoints
that every rank joins (train/engine.py), the log-likelihood is the sum of
each rank's part (its rows, its SNP block), so every rank keeps the same
restart, and rank 0 alone writes. The checkpoint lives in ``--save_dir``,
which every host must see. A grid refuses ``--cv``, as the JAX package
refuses it across processes.
"""
import logging
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..infer import (grid_devices, input_dims, read_packed, read_packed_rows,
                     select_device)
from ..io.snp_reader import input_format
from ..io.torch_interop import save_pt_checkpoint
from ..io.writers import save_checkpoint, save_config, write_outputs
from ..ops.loglikelihood import loglikelihood_packed
from ..ops.rsvd import resident_bytes, rsvd
from ..parallel.distributed import is_master, spawn_grid
from ..parallel.grid import DATA_AXIS, SNP_AXIS
from ..utils.hbm import should_stream_host
from ..utils.logger import log, setup_logging
from .cv import run_cross_validation
from .engine import NeuralAdmixtureTrainer, TrainConfig
from .init import (encode_populations, init_p_supervised_packed,
                   init_p_unsupervised, pca_coords)

# The JAX package's refusal of --cv across processes (train/run.py:213-215).
CV_ONE_PROCESS = "--cv runs single-process (each fold re-slices sample rows)."

# --stream as the JAX package's train/run.py normalises it: YAML configs
# bypass argparse's choices and may give ints or bools.
STREAM_MAP = {"auto": None, None: None, "0": False, 0: False, False: False,
              "1": True, 1: True, True: True}


def check_ported(args) -> None:
    """Raise on a --stream value outside auto/0/1, as the JAX package
    does."""
    stream = getattr(args, "stream", "auto")
    if stream not in STREAM_MAP:
        raise ValueError(f"--stream must be auto, 0, or 1; got {stream!r}")


def _resolve_mesh_shape(args, hosts=None):
    """(n_data, n_snp) from --mesh 'DxS', else --num_gpus N > 0 cards on
    every host, all data-parallel (the reference's semantics), else None:
    the trainer's auto policy over one CPU rank per host (the JAX
    package's _resolve_mesh_shape, train/run.py:45-58)."""
    mesh = getattr(args, "mesh", None)
    if mesh:
        n_data, n_snp = (int(v) for v in mesh.lower().split("x"))
        return (n_data, n_snp)
    if int(args.num_gpus) > 0:
        return ((hosts.count if hosts else 1) * int(args.num_gpus), 1)
    return None


def read_pops(pops_path: str):
    """The labels of ``--pops_path``, one per line, blank lines skipped (as
    the JAX package's train/run.py _read_pops)."""
    log.info("    Population file provided!")
    with open(pops_path, "r") as fb:
        return [p.strip() for p in fb.readlines() if p.strip()]


def _ks(args):
    """(K, min_k, max_k, ks) of --k or --min_k/--max_k."""
    if args.k is not None:
        return int(args.k), None, None, [int(args.k)]
    return None, int(args.min_k), int(args.max_k), \
        list(range(int(args.min_k), int(args.max_k) + 1))


def _train_config(args, ks, stream, device: str, **kw) -> TrainConfig:
    return TrainConfig(
        epochs=int(args.epochs), batch_size=int(args.batch_size),
        learning_rate=float(args.learning_rate), seed=int(args.seed),
        hidden_size=int(args.hidden_size),
        n_components=int(args.n_components), ks=ks,
        supervised_loss_weight=float(args.supervised_loss_weight),
        sample_block=int(args.sample_block or 1), device=device,
        stream=stream, checkpoint_every=int(args.checkpoint_every or 0),
        checkpoint_path=str(Path(args.save_dir) / f"{args.name}_ckpt.npz"),
        resume=bool(args.resume), profile_dir=args.profile_dir or None,
        **kw)


def _setup_stream(stream, n: int, W: int, args, device) -> bool:
    """Whether the RSVD and the P init stream ``n`` packed rows of ``W``
    bytes from host memory: ``--stream`` when given, else by the RSVD's
    estimate (the larger of the two)."""
    return stream if stream is not None else should_stream_host(
        resident_bytes(n, W, int(args.n_components)), device=device)


def _make_save_dir(args) -> None:
    """Create ``--save_dir`` where checkpoints need it before training."""
    if int(args.checkpoint_every or 0) or args.resume:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)


def _labels(args, N: int, K):
    """The numeric labels of --pops_path (None without it)."""
    if not args.pops_path:
        return None
    pops = read_pops(args.pops_path)
    if K is None:
        raise ValueError("Supervised mode requires --k (a single K).")
    if len(pops) != N:
        raise ValueError(f"Population file has {len(pops)} labels but "
                         f"the data has {N} samples.")
    return encode_populations(pops, K)[0]


def _save(args, params, Qs, Ps, ks, M: int, n_features: int) -> None:
    K, min_k, max_k, _ = _ks(args)
    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    save_checkpoint(params, args.name, args.save_dir, strip_decoders=True)
    save_pt_checkpoint(params, args.name, args.save_dir, num_snps=M)
    save_config(args.name, args.save_dir, ks=ks, num_features=n_features,
                hidden_size=int(args.hidden_size), num_snps=M)
    write_outputs(Qs, args.name, K, min_k, max_k, args.save_dir, Ps)


def _log_lls(lls, ks, K) -> None:
    for k, ll in zip(ks, lls):
        suffix = "" if K is not None else f" for K={k}"
        # ':2f' (not ':.2f') is the reference's own format, kept for log
        # scrapers.
        log.info(f"    Log-likelihood{suffix}: {ll:2f}.")


def fit_restarts(trainer: NeuralAdmixtureTrainer, packed: np.ndarray,
                 V: np.ndarray, M: int, N: int, ks, restarts: int, seed: int,
                 lls_of: Callable, P_init: Optional[np.ndarray] = None,
                 x_pca: Optional[torch.Tensor] = None,
                 pops: Optional[np.ndarray] = None, host_rows=None
                 ) -> Tuple[int, List, List, Dict, List[float]]:
    """Train ``restarts`` independently seeded runs and keep the one with
    the largest sum of per-K log-likelihoods, the first on a tie (the JAX
    package's train/run.py:217-283). Run r draws its GMM init from ``seed +
    r`` (unsupervised, on the PCA coordinates ``x_pca``; supervised runs
    share ``P_init``) and so does the trainer (encoder init, pre-shuffle,
    plans); V is the caller's. With more than one run each checkpoints to
    its own file, ``_r{r}`` before ``.npz``, and resumes from it.
    ``lls_of(Qs, Ps)``: a run's per-K log-likelihoods (on a grid summed over
    the ranks, so that every rank keeps the same run). The trainer runs
    each; only the best run's numpy results are kept. Returns (r, Qs, Ps,
    params, lls) of the best."""
    cfg = trainer.cfg
    base_ckpt = cfg.checkpoint_path
    best = None
    try:
        for r in range(restarts):
            seed_r = seed + r
            if restarts > 1:
                log.info(f"    Restart {r + 1}/{restarts} (seed {seed_r})...")
                if base_ckpt:
                    cfg.checkpoint_path = (os.path.splitext(base_ckpt)[0]
                                           + f"_r{r}.npz")
            if pops is None:
                P_init = init_p_unsupervised(None, V, N, M, ks, seed_r,
                                             x_pca=x_pca)
            cfg.seed = seed_r
            Qs, Ps, params = trainer.launch_training(
                P_init, packed, V, M, N, pops=pops, host_rows=host_rows)
            lls = lls_of(Qs, Ps)
            if best is None or sum(lls) > sum(best[4]):
                best = (r, Qs, Ps, params, lls)
            del Qs, Ps, params
    finally:
        cfg.seed, cfg.checkpoint_path = seed, base_ckpt
    return best


def _train_grid(args, t0: float, hosts) -> int:
    """Start this host's ranks of the grid (each runs :func:`_train_rank`)."""
    ks = _ks(args)[3]
    stream = STREAM_MAP[getattr(args, "stream", "auto")]
    _make_save_dir(args)
    N, M = input_dims(args.data_path)
    shape = _resolve_mesh_shape(args, hosts)
    n_ranks = (shape[0] * shape[1] if shape else
               (hosts.count if hosts else 1))
    # The grid of --mesh, of --num_gpus, or the auto policy's; the snp axis
    # is checked against the padded width before any rank starts.
    shape = NeuralAdmixtureTrainer(_train_config(
        args, ks, stream, "cpu", mesh_shape=shape))._pick_mesh(
            -(-M // 2048) * 2048, n_ranks)
    n_local = n_ranks // (hosts.count if hosts else 1)
    devices, backend = grid_devices(int(args.num_gpus), shape, n_local,
                                    "training")
    spawn_grid(_train_rank, *shape, devices, backend,
               args=(args, stream, N, M, t0), hosts=hosts,
               threads=int(args.threads))
    return 0


def _train_rank(grid, args, stream, N: int, M: int, t0: float
                ) -> Tuple[int, List[float]]:
    """One rank of a grid's ``train``: this data row's rows, the set-up
    joined over the data group, sharded training (each restart), the
    log-likelihood summed over the grid; rank 0 writes. Returns the kept
    restart and its log-likelihoods."""
    K, _, _, ks = _ks(args)
    trainer = NeuralAdmixtureTrainer(_train_config(
        args, ks, stream, str(grid.device), mesh_shape=grid.shape,
        progress=not args.no_progress and is_master()), grid=grid)
    fmt = input_format(args.data_path)
    log.info(f"    Input format is {fmt}.")
    start, end, _ = trainer.sample_shard(-(-M // 2048) * 2048, N)
    packed = read_packed_rows(args.data_path, start, end, M, grid)
    log.info(f"    Data contains {N} samples and {M} SNPs (rank {grid.rank} "
             f"of a {grid.n_data}x{grid.n_snp} grid, data row {grid.d}, SNP "
             f"block {grid.s}; this one holds rows [{start}, {end})).")
    if not is_master():
        log.setLevel(logging.WARNING)
    y_num = _labels(args, N, K)
    rows, device = (start, end), grid.device
    setup_stream = _setup_stream(stream, end - start, packed.shape[1], args,
                                 device)
    local = packed if setup_stream else torch.from_numpy(packed).to(device)

    log.info("")
    log.info("    Running SVD...")
    log.info("")
    t_svd = time.time()
    V = rsvd(local, N, M, int(args.n_components), int(args.seed),
             device=device, stream=setup_stream, rows=rows, grid=grid)
    log.info(f"    Total time SVD: {time.time() - t_svd:.4f}s")
    log.info("")
    P_init = x_pca = None
    if y_num is not None:
        log.info("")
        log.info("    Running Supervised Mode...")
        log.info("")
        P_init = init_p_supervised_packed(local, y_num, K, M, device=device,
                                          stream=setup_stream, rows=rows,
                                          grid=grid)
    else:
        log.info("")
        log.info("    Running Gaussian Mixture in PCA subspace...")
        log.info("")
        x_pca = pca_coords(local, V, N, device=device, stream=setup_stream,
                           rows=rows, grid=grid)
    del local

    # Each rank's part of the log-likelihood: its rows, its SNP block.
    w_loc = packed.shape[1] // grid.n_snp
    c0 = grid.s * 4 * w_loc
    m_cols = max(0, min(M - c0, 4 * w_loc))
    block = np.ascontiguousarray(
        packed[:, grid.s * w_loc:(grid.s + 1) * w_loc])

    def lls_of(Qs, Ps):
        parts = torch.tensor([
            loglikelihood_packed(block, m_cols,
                                 P[c0:c0 + m_cols].astype(np.float64),
                                 Q[start:end].astype(np.float64),
                                 device=device)
            if m_cols and end > start else 0.0
            for Q, P in zip(Qs, Ps)], dtype=torch.float64,
            device=grid.comm_device)
        return grid.psum_(parts, (DATA_AXIS, SNP_AXIS),
                          "loglikelihood").tolist()

    r, Qs, Ps, params, lls = fit_restarts(
        trainer, packed, V, M, N, ks, int(args.init_restarts or 1),
        int(args.seed), lls_of, P_init=P_init, x_pca=x_pca, pops=y_num,
        host_rows=rows)
    _log_lls(lls, ks, K)
    if is_master():
        _save(args, params, Qs, Ps, ks, M, V.shape[0])
        log.info("")
        log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
        log.info("")
    return r, lls


def main_train(args, t0: float, hosts=None) -> int:
    setup_logging()
    check_ported(args)
    K, _, _, ks = _ks(args)
    shape = _resolve_mesh_shape(args, hosts)
    if (shape is None and hosts) or (shape and shape[0] * shape[1] > 1):
        if args.cv:
            raise ValueError(CV_ONE_PROCESS)
        return _train_grid(args, t0, hosts)
    device = select_device(int(args.num_gpus), "training")
    stream = STREAM_MAP[getattr(args, "stream", "auto")]
    fmt = input_format(args.data_path)
    if fmt is not None:
        log.info(f"    Input format is {fmt}.")
    packed, N, M = read_packed(args.data_path)
    log.info(f"    Data contains {N} samples and {M} SNPs.")
    y_num = _labels(args, N, K)
    # The RSVD and the P init share one upload, or stream.
    setup_stream = _setup_stream(stream, N, packed.shape[1], args, device)
    rows = packed if setup_stream else torch.from_numpy(packed).to(device)

    log.info("")
    log.info("    Running SVD...")
    log.info("")
    t_svd = time.time()
    V = rsvd(rows, N, M, int(args.n_components), int(args.seed),
             device=device, stream=setup_stream)
    log.info(f"    Total time SVD: {time.time() - t_svd:.4f}s")
    log.info("")
    P_init = x_pca = None
    if y_num is not None:
        log.info("")
        log.info("    Running Supervised Mode...")
        log.info("")
        P_init = init_p_supervised_packed(rows, y_num, K, M, device=device,
                                          stream=setup_stream)
    else:
        log.info("")
        log.info("    Running Gaussian Mixture in PCA subspace...")
        log.info("")
        # One projection, whatever the number of restarts.
        x_pca = pca_coords(rows, V, N, device=device, stream=setup_stream)
    del rows

    _make_save_dir(args)
    cfg = _train_config(args, ks, stream, str(device),
                        progress=not args.no_progress)
    if args.cv:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
        run_cross_validation(packed, N, M, ks, int(args.cv), int(args.seed),
                             cfg, args.name, args.save_dir, pops=y_num)
    _, Qs, Ps, params, lls = fit_restarts(
        NeuralAdmixtureTrainer(cfg), packed, V, M, N, ks,
        int(args.init_restarts or 1), int(args.seed),
        lambda Qs, Ps: [loglikelihood_packed(
            packed, M, P.astype(np.float64), Q.astype(np.float64),
            device=device) for Q, P in zip(Qs, Ps)],
        P_init=P_init, x_pca=x_pca, pops=y_num)
    _log_lls(lls, ks, K)
    _save(args, params, Qs, Ps, ks, M, V.shape[0])

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
