"""Train mode: read -> pack -> RSVD -> init P -> train -> save.

The JAX package's train/run.py ``main_train`` for the ported slice: a
PLINK BED, one device, unsupervised, one K. The packed rows go to the
device once and every consumer (RSVD, PCA projection, training, the Q
pass) reads them there; the (N, M) genotype matrix never exists.
Everything else raises NotImplementedError naming the ROADMAP.md item that
ports it.
"""
import time
from pathlib import Path

import numpy as np
import torch

from ..infer import read_packed, select_device
from ..io.torch_interop import save_pt_checkpoint
from ..io.writers import save_checkpoint, save_config, write_outputs
from ..ops.loglikelihood import loglikelihood_packed
from ..ops.rsvd import rsvd
from ..utils.logger import log, setup_logging
from .engine import NeuralAdmixtureTrainer, TrainConfig
from .init import init_p_unsupervised


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1 "
                               f"item {item}.")


def check_ported(args) -> None:
    """Raise on every option outside the ported slice."""
    if args.pops_path:
        raise _not_ported("Supervised mode (--pops_path)", "8 (multi-head "
                          "K ranges and supervised mode)")
    if args.k is None:
        raise _not_ported("--min_k/--max_k (several heads)", "8 (multi-head "
                          "K ranges and supervised mode)")
    if args.cv:
        raise _not_ported("--cv", "13 (CV, restarts and the bench)")
    if int(args.init_restarts or 1) > 1:
        raise _not_ported("--init_restarts > 1", "13 (CV, restarts and the "
                          "bench)")
    if args.checkpoint_every or args.resume:
        raise _not_ported("--checkpoint_every/--resume", "9 "
                          "(checkpoint/resume and preemption)")
    if str(args.stream) in ("1", "True", "true"):
        raise _not_ported("--stream 1 (host streaming)", "10 (host "
                          "streaming)")
    if args.profile_dir:
        raise _not_ported("--profile_dir (a profiler trace of the epochs)",
                          "13 (CV, restarts and the bench)")


def main_train(args, t0: float) -> int:
    setup_logging()
    check_ported(args)
    device = select_device(int(args.num_gpus), getattr(args, "mesh", None),
                           "training")
    K = int(args.k)
    packed, N, M = read_packed(args.data_path)
    log.info(f"    Data contains {N} samples and {M} SNPs.")
    packed_dev = torch.from_numpy(packed).to(device)

    log.info("")
    log.info("    Running SVD...")
    log.info("")
    t_svd = time.time()
    V = rsvd(packed_dev, N, M, int(args.n_components), int(args.seed))
    log.info(f"    Total time SVD: {time.time() - t_svd:.4f}s")
    log.info("")
    log.info("")
    log.info("    Running Gaussian Mixture in PCA subspace...")
    log.info("")
    P_init = init_p_unsupervised(packed_dev, V, N, M, [K], int(args.seed))
    del packed_dev

    cfg = TrainConfig(
        epochs=int(args.epochs), batch_size=int(args.batch_size),
        learning_rate=float(args.learning_rate), seed=int(args.seed),
        hidden_size=int(args.hidden_size),
        n_components=int(args.n_components), ks=[K],
        progress=not args.no_progress,
        sample_block=int(args.sample_block or 1), device=str(device))
    trainer = NeuralAdmixtureTrainer(cfg)
    Qs, Ps, params = trainer.launch_training(P_init, packed, V, M, N)

    ll = loglikelihood_packed(packed, M, Ps[0].astype(np.float64),
                              Qs[0].astype(np.float64), device=device)
    # ':2f' (not ':.2f') is the reference's own format, kept for log
    # scrapers.
    log.info(f"    Log-likelihood: {ll:2f}.")

    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    save_checkpoint(params, args.name, args.save_dir, strip_decoders=True)
    save_pt_checkpoint(params, args.name, args.save_dir, num_snps=M)
    save_config(args.name, args.save_dir, ks=[K], num_features=V.shape[0],
                hidden_size=int(args.hidden_size), num_snps=M)
    write_outputs(Qs, args.name, K, None, None, args.save_dir, Ps)

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
