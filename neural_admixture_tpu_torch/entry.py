"""CLI entry point: ``neural-admixture-tpu-torch {train,infer} ...``.

The flag surface of the JAX package's CLI, with YAML config-file support
(``--config file.yaml``). Ported so far, on a PLINK .bed, a PGEN or a VCF:
``train`` with one K (``--k``) or a K range (``--min_k``/``--max_k``, one
head per K), unsupervised or supervised (``--pops_path``, one K), with
resumable checkpoints (``--checkpoint_every``, ``--resume``) and host
streaming (``--stream``) on one device, and ``infer``. Both run on the card
by default (``--num_gpus 1``); ``--num_gpus 0`` asks for the CPU, and
``--mesh 1x1`` is that one device.

Several devices (parallel/): ``--num_gpus N > 1`` trains or infers on N
cards, one rank each over NCCL, all data-parallel; ``--mesh DxS`` on a
(data, snp) grid of D x S ranks (on cards, or with ``--num_gpus 0`` on CPU
ranks over gloo). Several hosts join through the JAX package's variables
NA_TPU_COORDINATOR (host:port of the host that runs rank 0),
NA_TPU_NUM_PROCESSES (the number of hosts) and NA_TPU_PROCESS_ID (this
host's index), each host starting its own ranks. ``--num_gpus`` above the
visible cards warns and uses those there are, as in the JAX package.

Every flag of the JAX package runs: K-fold cross-validation (``--cv``, one
process only: a grid of ranks refuses it, as the JAX package refuses it
across processes), independently seeded restarts (``--init_restarts``)
and a torch.profiler trace of the epochs (``--profile_dir``), on one
device and, but for ``--cv``, on a grid. The JAX package's environment
variables
``NA_TPU_INDEXED``, ``NA_TPU_SPLIT_LOSS`` and ``NA_TPU_FORCE_MASKED``
choose the training program (train/engine.py).
"""
import argparse
import logging
import os
import re
import sys
import time
from typing import List, Optional


def _early_pin_threads() -> None:
    """BLAS/OpenMP pools size themselves at ``import numpy`` -- which the
    imports just below trigger -- so ``--threads`` must reach the
    environment before them. Scans sys.argv directly; no-op when the flag
    is absent. Programmatic ``main(argv)`` callers get only the late
    ``_pin_threads``."""
    val = None
    for i, tok in enumerate(sys.argv):
        if tok == "--threads" and i + 1 < len(sys.argv):
            val = sys.argv[i + 1]
        elif tok.startswith("--threads="):
            val = tok.split("=", 1)[1]
    if val and val.isdigit():
        _pin_threads(int(val))


def _pin_threads(threads: int) -> None:
    for var in ("NUMEXPR_MAX_THREADS", "NUMEXPR_NUM_THREADS",
                "MKL_MAX_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_MAX_THREADS", "OPENBLAS_NUM_THREADS",
                "OMP_MAX_THREADS", "OMP_NUM_THREADS"):
        os.environ[var] = str(threads)


_early_pin_threads()

import torch  # noqa: E402

from . import __version__  # noqa: E402
from .utils.logger import log, setup_logging  # noqa: E402
from .utils.seeding import set_seed  # noqa: E402


class _ConfigParser(argparse.ArgumentParser):
    """ArgumentParser that records its own actions as ``add_argument``
    returns them, so YAML config support needs no argparse private API."""

    def __init__(self, *a, **kw):
        # Before super().__init__: the base constructor itself registers
        # the -h/--help action through add_argument.
        self.config_actions: List[argparse.Action] = []
        super().__init__(*a, **kw)

    def add_argument(self, *a, **kw):
        action = super().add_argument(*a, **kw)
        self.config_actions.append(action)
        return action


def _add_config_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", required=False, default=None, type=str,
                        help="YAML file with default values for any flag.")


def _apply_yaml_defaults(parser: "_ConfigParser", argv: List[str]):
    """configargparse-style YAML config support: values in the YAML file
    become parser defaults (CLI flags still win), and required flags
    provided by the file are no longer demanded on the command line."""
    # argparse accepts unambiguous abbreviations like '--conf'; the pre-scan
    # accepts exactly the same spellings.
    opts = [s for a in parser.config_actions for s in a.option_strings
            if s.startswith("--")]

    def _is_config_flag(tok: str) -> bool:
        if not tok.startswith("--") or len(tok) < 3:
            return False
        return [o for o in opts if o.startswith(tok)] == ["--config"]

    cfg_path = None
    for i, tok in enumerate(argv):
        head, _, tail = tok.partition("=")
        if _is_config_flag(head):
            cfg_path = tail if tail else (
                argv[i + 1] if i + 1 < len(argv) else None)
    if not cfg_path:
        return
    import yaml
    with open(cfg_path, "r") as fb:
        cfg = yaml.safe_load(fb) or {}
    dests = {a.dest: a for a in parser.config_actions}
    unknown = [k for k in cfg if k not in dests]
    if unknown:
        parser.error(f"unknown keys in config file {cfg_path}: {unknown}")
    for key, value in list(cfg.items()):
        action = dests[key]
        # YAML scalars like "1e-4" resolve to strings under YAML 1.1; apply
        # the flag's argparse type converter (as configargparse does).
        if action.type is not None and isinstance(value, str):
            cfg[key] = action.type(value)
    parser.set_defaults(**cfg)
    for action in parser.config_actions:
        if action.required and action.dest in cfg:
            action.required = False


def parse_train_args(argv: List[str]) -> argparse.Namespace:
    parser = _ConfigParser(
        prog="neural-admixture-tpu-torch train",
        description="Rapid population clustering with autoencoders - "
                    "training mode")
    _add_config_arg(parser)
    parser.add_argument("--epochs", required=False, type=int, default=250,
                        help="Maximum number of epochs.")
    parser.add_argument("--batch_size", required=False, default=800, type=int,
                        help="Batch size.")
    parser.add_argument("--learning_rate", required=False, default=20e-4,
                        type=float, help="Learning rate.")
    parser.add_argument("--seed", required=False, type=int, default=42,
                        help="Seed")
    parser.add_argument("--k", required=False, type=int,
                        help="Number of populations/clusters.")
    parser.add_argument("--min_k", required=False, type=int,
                        help="Minimum number of populations/clusters "
                        "(multi-head).")
    parser.add_argument("--max_k", required=False, type=int,
                        help="Maximum number of populations/clusters "
                        "(multi-head).")
    parser.add_argument("--hidden_size", required=False, default=1024,
                        type=int, help="Dimension of first projection in "
                        "encoder.")
    parser.add_argument("--save_dir", required=True, type=str,
                        help="Save model in this directory")
    parser.add_argument("--data_path", required=True, type=str,
                        help="Path containing the main data")
    parser.add_argument("--name", required=True, type=str,
                        help="Experiment/model name")
    parser.add_argument("--supervised_loss_weight", required=False,
                        default=100, type=float,
                        help="Weight given to the supervised loss.")
    parser.add_argument("--pops_path", required=False, default="", type=str,
                        help="Path containing the main data populations "
                        "(supervised mode).")
    parser.add_argument("--n_components", required=False, type=int,
                        default=8, help="Number of components to use for "
                        "the SVD initialization.")
    parser.add_argument("--num_gpus", required=False, default=1, type=int,
                        help="Number of devices on each host: 1 (default) "
                        "= one CUDA card, N > 1 = N cards (one rank each, "
                        "data-parallel), 0 = the CPU.")
    parser.add_argument("--mesh", required=False, default=None, type=str,
                        help="Grid of ranks as DATAxSNP (samples over DATA, "
                        "SNPs over SNP); with --num_gpus 0, CPU ranks.")
    parser.add_argument("--sample_block", required=False, default=16,
                        type=int, help="Batch sampling granularity: draw "
                        "random runs of this many consecutive (pre-shuffled) "
                        "samples instead of single rows (1 = per-row "
                        "shuffling).")
    parser.add_argument("--stream", required=False, default="auto",
                        choices=("auto", "0", "1"),
                        help="Host-streaming (out-of-core) training: 1 "
                        "keeps the packed rows in host memory and streams "
                        "every batch and block to the device; 0 keeps them "
                        "resident on the device; 'auto' streams only when "
                        "they do not fit.")
    parser.add_argument("--init_restarts", required=False, default=1,
                        type=int, help="Train this many independently "
                        "seeded runs (fresh GMM init and training draws, "
                        "seeds seed..seed+R-1; V from --seed) and keep the "
                        "best by log-likelihood. The converged LL varies by "
                        "a few thousand units with the init draw; restarts "
                        "recover that spread at R x the training cost. "
                        "Default 1 (reference behavior).")
    parser.add_argument("--cv", required=False, default=None, type=int,
                        help="Number of folds for cross-validation before "
                        "the full-data fit: per fold, multi-head training "
                        "on the other folds, the held-out samples projected "
                        "through the trained encoder, and per K the mean "
                        "and std of the validation error logged and written "
                        "to {name}.cv_errors.csv. One process only: a grid "
                        "of ranks refuses it.")
    parser.add_argument("--threads", required=False, default=1, type=int,
                        help="Number of threads to be used during execution.")
    parser.add_argument("--no_progress", action="store_true",
                        help="Disable the epoch progress line.")
    parser.add_argument("--profile_dir", required=False, default=None,
                        type=str, help="Write a torch.profiler (Chrome "
                        "JSON) trace of the training epochs to this "
                        "directory, one file per rank.")
    parser.add_argument("--checkpoint_every", required=False, default=0,
                        type=int, help="Save a resumable checkpoint "
                        "({save_dir}/{name}_ckpt.npz) every N epochs (0 = "
                        "off); then SIGTERM saves one at the next epoch and "
                        "exits 143.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the checkpoint in save_dir when "
                        "there is one.")
    _apply_yaml_defaults(parser, argv)
    return parser.parse_args(argv)


def parse_infer_args(argv: List[str]) -> argparse.Namespace:
    parser = _ConfigParser(
        prog="neural-admixture-tpu-torch infer",
        description="Rapid population clustering with autoencoders - "
                    "inference mode")
    _add_config_arg(parser)
    parser.add_argument("--out_name", required=True, type=str,
                        help="Name used to output files on inference mode.")
    parser.add_argument("--save_dir", required=True, type=str,
                        help="Load model from this directory.")
    parser.add_argument("--data_path", required=True, type=str,
                        help="Path containing the main data.")
    parser.add_argument("--name", required=True, type=str,
                        help="Trained experiment/model name.")
    parser.add_argument("--batch_size", required=False, default=1024, type=int,
                        help="Batch size.")
    parser.add_argument("--seed", required=False, type=int, default=42,
                        help="Seed")
    parser.add_argument("--num_gpus", required=False, default=1, type=int,
                        help="Number of devices on each host: 1 (default) "
                        "= one CUDA card, N > 1 = N cards (one rank each, "
                        "data-parallel), 0 = the CPU.")
    parser.add_argument("--mesh", required=False, default=None, type=str,
                        help="Grid of ranks as DATAxSNP (samples over DATA, "
                        "SNPs over SNP); with --num_gpus 0, CPU ranks.")
    parser.add_argument("--threads", required=False, default=1, type=int,
                        help="Number of threads to be used during execution.")
    _apply_yaml_defaults(parser, argv)
    return parser.parse_args(argv)


def print_banner(version: str = __version__) -> None:
    log.info(f"\n    Neural ADMIXTURE -- PyTorch/CUDA engine, version "
             f"{version}\n")


def _validate(mode: str, args: argparse.Namespace) -> None:
    if args.threads <= 0:
        raise ValueError("Please select a valid number of threads (>0).")
    if args.seed < 0:
        raise ValueError("Please select a valid seed (>=0).")
    if args.num_gpus < 0:
        raise ValueError("Number of devices must be >= 0.")
    if args.batch_size <= 0:
        raise ValueError("Batch size must be > 0.")
    if args.mesh and not re.fullmatch(r"[1-9]\d*x[1-9]\d*", args.mesh):
        raise ValueError(f"--mesh must look like '4x2' (data x snp), got "
                         f"'{args.mesh}'.")
    if mode != "train":
        return
    for name in ("epochs", "learning_rate", "hidden_size", "n_components",
                 "sample_block"):
        if getattr(args, name) <= 0:
            raise ValueError(f"--{name} must be > 0.")
    if args.supervised_loss_weight < 0:
        raise ValueError("Supervised loss weight must be >= 0.")
    if args.cv is not None and args.cv < 2:
        raise ValueError("Number of cross-validation folds must be >= 2.")
    if args.init_restarts < 1:
        raise ValueError("init_restarts must be >= 1.")
    if args.k is not None:
        if args.k <= 1:
            raise ValueError("Please select K > 1.")
        log.info(f"    Running on K = {args.k}.")
    elif args.min_k is not None and args.max_k is not None:
        if args.min_k <= 1:
            raise ValueError("min_k must be greater than 1.")
        if args.max_k <= args.min_k:
            raise ValueError("max_k must be greater than min_k.")
        log.info(f"    Running from K={args.min_k} to K={args.max_k}.")
    else:
        raise ValueError("Please provide either --k or both --min_k and "
                         "--max_k.")


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging(logging.INFO)
    print_banner()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise ValueError('Please provide either the argument "train" or '
                         '"infer" to choose the running mode.')
    mode = argv[0]
    if mode == "train":
        args = parse_train_args(argv[1:])
    elif mode == "infer":
        args = parse_infer_args(argv[1:])
    else:
        raise ValueError(f'Unknown mode "{mode}". Please use "train" or '
                         '"infer".')

    _validate(mode, args)
    t0 = time.time()
    _pin_threads(args.threads)
    torch.set_num_threads(args.threads)
    log.info(f"    Using {args.threads} threads...")
    set_seed(args.seed)

    # Several hosts: from the NA_TPU_* variables (raises on a partial set).
    from .parallel.distributed import maybe_initialize_distributed
    hosts = maybe_initialize_distributed()

    # The device-count clamp, as the JAX package's entry.py:341-348 (the
    # reference's GPU clamp); no card at all is no clamp but an error.
    if args.num_gpus > 1:
        available = torch.cuda.device_count()
        if available == 0:
            raise RuntimeError(
                f"--num_gpus {args.num_gpus} asks for CUDA devices, but no "
                "CUDA device is available (torch.cuda.device_count() is 0). "
                "Use --num_gpus 0 to run on the CPU.")
        if args.num_gpus > available:
            log.warning(f"    Requested {args.num_gpus} devices, but only "
                        f"{available} are available. Using {available} "
                        "devices.")
            args.num_gpus = available

    if mode == "train":
        from .train.run import main_train
        return main_train(args, t0, hosts)
    from .infer import main_infer
    return main_infer(args, t0, hosts)


if __name__ == "__main__":
    sys.exit(main())
