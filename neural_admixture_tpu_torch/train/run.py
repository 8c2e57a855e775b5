"""Train mode: read -> pack -> RSVD -> init P -> train -> save.

The JAX package's train/run.py ``main_train`` for the ported slice: a
PLINK BED, a PGEN or a VCF on one device, one K (``--k``) or a K range
(``--min_k`` .. ``--max_k``, one head per K, trained jointly), unsupervised
or supervised (``--pops_path``, one K), with resumable checkpoints
(``--checkpoint_every``, ``--resume``, SIGTERM) and host streaming
(``--stream``). Resident, the packed rows go to the device once for the
RSVD and the P init and once more for training; streamed (``--stream 1``,
or ``auto`` when they do not fit), no phase uploads the whole packed
matrix: the RSVD, the PCA projection or the supervised means, training,
the Q pass and the log-likelihood read it block by block through the stager
(io/stage.py). The (N, M) genotype matrix never exists. Everything else
raises NotImplementedError naming the ROADMAP.md item that ports it.
"""
import time
from pathlib import Path

import numpy as np
import torch

from ..infer import read_packed, select_device
from ..io.snp_reader import input_format
from ..io.torch_interop import save_pt_checkpoint
from ..io.writers import save_checkpoint, save_config, write_outputs
from ..ops.loglikelihood import loglikelihood_packed
from ..ops.rsvd import resident_bytes, rsvd
from ..utils.hbm import should_stream_host
from ..utils.logger import log, setup_logging
from .engine import NeuralAdmixtureTrainer, TrainConfig
from .init import (encode_populations, init_p_supervised_packed,
                   init_p_unsupervised)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1 "
                               f"item {item}.")


# --stream as the JAX package's train/run.py normalises it: YAML configs
# bypass argparse's choices and may give ints or bools.
STREAM_MAP = {"auto": None, None: None, "0": False, 0: False, False: False,
              "1": True, 1: True, True: True}


def check_ported(args) -> None:
    """Raise on every option outside the ported slice, and on a --stream
    value outside auto/0/1 as the JAX package does."""
    stream = getattr(args, "stream", "auto")
    if stream not in STREAM_MAP:
        raise ValueError(f"--stream must be auto, 0, or 1; got {stream!r}")
    if args.cv:
        raise _not_ported("--cv", "13 (CV, restarts and the bench)")
    if int(args.init_restarts or 1) > 1:
        raise _not_ported("--init_restarts > 1", "13 (CV, restarts and the "
                          "bench)")
    if args.profile_dir:
        raise _not_ported("--profile_dir (a profiler trace of the epochs)",
                          "13 (CV, restarts and the bench)")


def read_pops(pops_path: str):
    """The labels of ``--pops_path``, one per line, blank lines skipped (as
    the JAX package's train/run.py _read_pops)."""
    log.info("    Population file provided!")
    with open(pops_path, "r") as fb:
        return [p.strip() for p in fb.readlines() if p.strip()]


def main_train(args, t0: float) -> int:
    setup_logging()
    check_ported(args)
    if args.k is not None:
        K, min_k, max_k = int(args.k), None, None
        ks = [K]
    else:
        K, min_k, max_k = None, int(args.min_k), int(args.max_k)
        ks = list(range(min_k, max_k + 1))
    device = select_device(int(args.num_gpus), getattr(args, "mesh", None),
                           "training")
    stream = STREAM_MAP[getattr(args, "stream", "auto")]
    fmt = input_format(args.data_path)
    if fmt is not None:
        log.info(f"    Input format is {fmt}.")
    packed, N, M = read_packed(args.data_path)
    log.info(f"    Data contains {N} samples and {M} SNPs.")
    y_num = None
    if args.pops_path:
        pops = read_pops(args.pops_path)
        if K is None:
            raise ValueError("Supervised mode requires --k (a single K).")
        if len(pops) != N:
            raise ValueError(f"Population file has {len(pops)} labels but "
                             f"the data has {N} samples.")
        y_num, _ = encode_populations(pops, K)
    # The RSVD and the P init share one upload, or stream (auto: by the
    # RSVD's estimate, the larger of the two).
    setup_stream = stream if stream is not None else should_stream_host(
        resident_bytes(N, packed.shape[1], int(args.n_components)),
        device=device)
    rows = packed if setup_stream else torch.from_numpy(packed).to(device)

    log.info("")
    log.info("    Running SVD...")
    log.info("")
    t_svd = time.time()
    V = rsvd(rows, N, M, int(args.n_components), int(args.seed),
             device=device, stream=setup_stream)
    log.info(f"    Total time SVD: {time.time() - t_svd:.4f}s")
    log.info("")
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
        P_init = init_p_unsupervised(rows, V, N, M, ks, int(args.seed),
                                     device=device, stream=setup_stream)
    del rows

    checkpoint_every = int(args.checkpoint_every or 0)
    if checkpoint_every or args.resume:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    cfg = TrainConfig(
        epochs=int(args.epochs), batch_size=int(args.batch_size),
        learning_rate=float(args.learning_rate), seed=int(args.seed),
        hidden_size=int(args.hidden_size),
        n_components=int(args.n_components), ks=ks,
        supervised_loss_weight=float(args.supervised_loss_weight),
        progress=not args.no_progress,
        sample_block=int(args.sample_block or 1), device=str(device),
        stream=stream, checkpoint_every=checkpoint_every,
        checkpoint_path=str(Path(args.save_dir) / f"{args.name}_ckpt.npz"),
        resume=bool(args.resume))
    trainer = NeuralAdmixtureTrainer(cfg)
    Qs, Ps, params = trainer.launch_training(P_init, packed, V, M, N,
                                             pops=y_num)

    for i, k in enumerate(ks):
        ll = loglikelihood_packed(packed, M, Ps[i].astype(np.float64),
                                  Qs[i].astype(np.float64), device=device)
        suffix = "" if K is not None else f" for K={k}"
        # ':2f' (not ':.2f') is the reference's own format, kept for log
        # scrapers.
        log.info(f"    Log-likelihood{suffix}: {ll:2f}.")

    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    save_checkpoint(params, args.name, args.save_dir, strip_decoders=True)
    save_pt_checkpoint(params, args.name, args.save_dir, num_snps=M)
    save_config(args.name, args.save_dir, ks=ks, num_features=V.shape[0],
                hidden_size=int(args.hidden_size), num_snps=M)
    write_outputs(Qs, args.name, K, min_k, max_k, args.save_dir, Ps)

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
