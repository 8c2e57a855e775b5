"""CLI entry point: ``neural-admixture-tpu-torch infer ...``.

The flag surface of the JAX package's CLI, with YAML config-file support
(``--config file.yaml``). Ported so far: ``infer`` on one device. It runs on
the card by default (``--num_gpus 1``); ``--num_gpus 0`` asks for the CPU.
``train``, ``--num_gpus > 1`` and ``--mesh`` raise "not ported yet".
"""
import argparse
import logging
import os
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
                        help="Number of devices: 1 (default) = the CUDA "
                        "card, 0 = CPU. More than one is not ported yet.")
    parser.add_argument("--mesh", required=False, default=None, type=str,
                        help="Device mesh as DATAxSNP; not ported yet.")
    parser.add_argument("--threads", required=False, default=1, type=int,
                        help="Number of threads to be used during execution.")
    _apply_yaml_defaults(parser, argv)
    return parser.parse_args(argv)


def print_banner(version: str = __version__) -> None:
    log.info(f"\n    Neural ADMIXTURE -- PyTorch/CUDA engine, version "
             f"{version}\n")


def _validate(args: argparse.Namespace) -> None:
    if args.threads <= 0:
        raise ValueError("Please select a valid number of threads (>0).")
    if args.seed < 0:
        raise ValueError("Please select a valid seed (>=0).")
    if args.num_gpus < 0:
        raise ValueError("Number of devices must be >= 0.")
    if args.batch_size <= 0:
        raise ValueError("Batch size must be > 0.")


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging(logging.INFO)
    print_banner()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise ValueError('Please provide the argument "infer" to choose the '
                         'running mode.')
    mode = argv[0]
    if mode == "train":
        raise NotImplementedError(
            "train is not ported yet: ROADMAP.md Queue 1 items 2-6 (the "
            "training slice). Use neural_admixture_tpu for training.")
    if mode != "infer":
        raise ValueError(f'Unknown mode "{mode}". Please use "infer".')
    args = parse_infer_args(argv[1:])

    _validate(args)
    t0 = time.time()
    _pin_threads(args.threads)
    torch.set_num_threads(args.threads)
    log.info(f"    Using {args.threads} threads...")
    set_seed(args.seed)

    from .infer import main_infer
    return main_infer(args, t0)


if __name__ == "__main__":
    sys.exit(main())
