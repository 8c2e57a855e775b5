"""Projective inference: run a trained encoder on new data, write .Q files.

Load ``{name}_config.json`` and the decoder-stripped weights (``.npz``, or a
reference-format ``.pt``), run the encoder over the packed rows in batches
(xv kernel -> encoder), and write ``{out_name}.{K}.Q``. The batches leave
host memory through the stager (io/stage.py): gathered into a pinned ring,
copied on a side stream while the previous batch computes.
"""
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from .io.snp_reader import exit_unrecognized, input_format
from .io.torch_interop import load_pt_checkpoint
from .io.writers import load_checkpoint, load_config, write_outputs
from .models.qp import head_keys, params_from_numpy
from .ops.pack import packed_has_missing
from .train.chunked import chunked_forward
from .utils.logger import log, setup_logging

# Lane multiple of V's rows in the JAX package's checkpoints (and of the
# packed width the readers produce).
_LANE = 2048


def mesh_size(mesh) -> int:
    """Devices of a ``--mesh`` 'DxS' (data x snp), 1 without one."""
    if not mesh:
        return 1
    n_data, n_snp = (int(s) for s in mesh.lower().split("x"))
    return n_data * n_snp


def select_device(num_gpus: int, mesh=None,
                  what: str = "inference") -> torch.device:
    """``--num_gpus 0`` is the CPU, 1 the card; a ``--mesh`` of one device
    (1x1) is the same single device, as in the JAX package. No other choice
    is ported.

    Never falls back: asking for the card on a host without one raises."""
    if mesh_size(mesh) > 1 or num_gpus > 1:
        raise NotImplementedError(
            f"{what.capitalize()} over several devices (--num_gpus > 1 or "
            "--mesh) is not ported yet: ROADMAP.md Queue 1 item 12 "
            "(multi-GPU).")
    if num_gpus == 0:
        log.info(f"    Running {what} on CPU (--num_gpus 0).")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--num_gpus 1 asks for a CUDA device, but no CUDA device is "
            "available (torch.cuda.is_available() is False). Use --num_gpus "
            "0 to run on the CPU.")
    log.info(f"    Running {what} on {torch.cuda.get_device_name(0)}.")
    return torch.device("cuda", 0)


def infer_q(params, packed: np.ndarray, N: int, ks: List[int],
            batch_size: int = 1024, device="cuda") -> List[np.ndarray]:
    """Q (N, k) for each k in sorted ``ks``, from the numpy parameter dict
    and the (N, W) packed rows, on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("infer_q was asked for a CUDA device, but no CUDA "
                           "device is available.")
    model = params_from_numpy(params, ks, device=device)
    no_missing = not packed_has_missing(packed)
    with torch.no_grad():
        qs = chunked_forward(lambda blk: model(blk, no_missing), packed, N,
                             min(N, batch_size), device)
    return [qs[hk] for hk in head_keys(ks)]


def read_packed(data_path: str):
    """(packed (N, W) uint8, N, M) of a PLINK .bed, a PGEN or a VCF (plain
    or .gz), by its suffix, through the packed reader of each format;
    any other suffix logs the reference's error and exits 1."""
    fmt = input_format(data_path)
    if fmt == "BED":
        from .io.bed import read_bed_packed
        return read_bed_packed(data_path)
    if fmt == "PGEN":
        from .io.pgen import read_pgen_packed
        return read_pgen_packed(data_path)
    if fmt == "VCF":
        from .io.vcf import read_vcf_packed
        return read_vcf_packed(data_path)
    exit_unrecognized()


def main_infer(args, t0: float) -> int:
    setup_logging()
    device = select_device(int(args.num_gpus), getattr(args, "mesh", None))

    try:
        config = load_config(args.name, args.save_dir)
    except FileNotFoundError:
        log.error(f"    Config file ({args.save_dir}/{args.name}_config.json) "
                  "not found. Make sure it is in the correct directory and "
                  "with the correct name.")
        return 1

    log.info("    Model config file loaded. Loading weights...")
    from_torch = False
    try:
        params = load_checkpoint(args.name, args.save_dir)
    except FileNotFoundError:
        # Models trained by the reference implementation: its torch
        # state-dict format.
        pt = Path(args.save_dir) / f"{args.name}.pt"
        if not pt.exists():
            log.error(f"    No weights found: neither {args.save_dir}/"
                      f"{args.name}.npz nor {pt} exists.")
            return 1
        log.info(f"    Loading reference-format torch weights ({pt}).")
        params = load_pt_checkpoint(args.name, args.save_dir,
                                    [int(k) for k in config["ks"]])
        from_torch = True
    log.info("")
    log.info("    Model weights loaded.")
    log.info("")

    packed, N, M = read_packed(args.data_path)
    trained_m = config.get("num_snps")
    if from_torch:
        # A reference .pt stores V with exactly the trained M rows; pad V to
        # the packed lane multiple so the widths line up (zero rows add
        # nothing to X @ V).
        trained_m = params["V"].shape[0] if trained_m is None else trained_m
        m_aligned = -(-params["V"].shape[0] // _LANE) * _LANE
        pad = m_aligned - params["V"].shape[0]
        if pad:
            params["V"] = np.concatenate(
                [params["V"],
                 np.zeros((pad, params["V"].shape[1]), np.float32)], axis=0)
    if trained_m is not None:
        if M != int(trained_m):
            raise ValueError(
                f"Data has {M} SNPs but the model was trained on {trained_m}; "
                "projective inference requires the same variant set.")
    else:
        log.warning(
            "    Config has no 'num_snps' entry; cannot verify the dataset "
            f"matches the trained variant set (data has {M} SNPs, V has "
            f"{params['V'].shape[0]} padded rows). A mismatched variant set "
            "produces meaningless Q values.")
    if params["V"].shape[0] < M:
        raise ValueError(f"Data has {M} SNPs but the model was trained with "
                         f"{params['V'].shape[0]} (padded) SNP rows in V.")
    if packed.shape[1] * 4 != params["V"].shape[0]:
        # The reader pads M to 2048-SNP lanes, as training pads V, so widths
        # agree whenever the variant sets match; a torch config without
        # num_snps can leave V wider. Zero columns are inert.
        want_w = params["V"].shape[0] // 4
        if want_w < packed.shape[1]:
            raise ValueError(
                f"Packed data is {packed.shape[1] * 4} (padded) SNPs wide but "
                f"V has only {params['V'].shape[0]} rows.")
        packed = np.pad(packed, ((0, 0), (0, want_w - packed.shape[1])))

    log.info("    Running inference...")
    # Qs come back in ascending-K order; sort the config's list the same way
    # so file names match their contents.
    ks = sorted(int(k) for k in config["ks"])
    Qs = infer_q(params, packed, N, ks, int(args.batch_size), device)
    log.info("    Inference run successfully! Writing outputs...!")

    if len(ks) == 1:
        write_outputs(Qs, args.out_name, ks[0], None, None, args.save_dir)
    elif ks == list(range(ks[0], ks[-1] + 1)):
        write_outputs(Qs, args.out_name, None, ks[0], ks[-1], args.save_dir)
    else:
        # Non-contiguous K list: write each K by name.
        for i, k in enumerate(ks):
            write_outputs([Qs[i]], args.out_name, k, None, None,
                          args.save_dir)

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
