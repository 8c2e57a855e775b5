"""Projective inference: run a trained encoder on new data, write .Q files.

Load ``{name}_config.json`` and the decoder-stripped weights (``.npz``, or a
reference-format ``.pt``), run the encoder over the packed rows in batches
(xv kernel -> encoder), and write ``{out_name}.{K}.Q``. The batches leave
host memory through the stager (io/stage.py): gathered into a pinned ring,
copied on a side stream while the previous batch computes.

Over a grid of ranks (``--num_gpus N > 1``, ``--mesh DxS``, or several
hosts; the JAX package's infer_q_mesh, infer.py:76-125): each data row reads
its own sample rows, each rank keeps its SNP block of them in host memory
(staged to the device by chunks) and V's rows of it, the encoder pass sums
X @ V over the snp group
(parallel/sharded_step.py infer_q_sharded), and rank 0 writes the rows of
every data row.
"""
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from .io.snp_reader import exit_unrecognized, input_format
from .io.torch_interop import load_pt_checkpoint
from .io.writers import load_checkpoint, load_config, write_outputs
from .models.qp import head_keys, params_from_numpy
from .ops.pack import packed_has_missing
from .parallel.distributed import (allsum_hosts, host_sample_shard,
                                   is_master, spawn_grid)
from .parallel.grid import DATA_AXIS, SNP_AXIS, shard_params
from .train.chunked import chunked_forward
from .utils.logger import log, setup_logging

# Lane multiple of V's rows in the JAX package's checkpoints (and of the
# packed width the readers produce).
_LANE = 2048


def select_device(num_gpus: int, what: str = "inference") -> torch.device:
    """The one device of a run on one rank: ``--num_gpus 0`` is the CPU, 1
    the card (a ``--mesh`` of 1x1 too, as in the JAX package).

    Never falls back: asking for the card on a host without one raises."""
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


def grid_devices(num_gpus: int, shape: Tuple[int, int], n_local: int,
                 what: str) -> Tuple[List[str], str]:
    """(devices, backend) of this host's ``n_local`` ranks of a grid of
    ``shape``: one CPU rank each over gloo with ``--num_gpus 0``, else one
    card each over NCCL; raises when the host has too few cards (the JAX
    package's message, train/engine.py:1627-1630). Several ranks share a
    card only through parallel.distributed.spawn_grid's own arguments."""
    if num_gpus == 0:
        log.info(f"    Running {what} on a {shape[0]}x{shape[1]} grid of CPU "
                 f"ranks over gloo (--num_gpus 0), {n_local} on this host.")
        return ["cpu"] * n_local, "gloo"
    available = torch.cuda.device_count()
    if available < n_local:
        raise ValueError(
            f"mesh_shape {tuple(shape)} needs {n_local} devices but only "
            f"{available} are available")
    log.info(f"    Running {what} on a {shape[0]}x{shape[1]} grid over NCCL, "
             f"{n_local} {torch.cuda.get_device_name(0)} on this host.")
    return [f"cuda:{i}" for i in range(n_local)], "nccl"


def input_dims(data_path: str) -> Tuple[int, int]:
    """(N, M) of a BED, PGEN or VCF without decoding genotypes; any other
    suffix logs the reference's error and exits 1."""
    fmt = input_format(data_path)
    if fmt == "BED":
        from .io.bed import read_bed_dims
        return read_bed_dims(data_path)
    if fmt == "PGEN":
        from .io.pgen import pgen_dims
        return pgen_dims(data_path)
    if fmt == "VCF":
        from .io.vcf import vcf_dims
        return vcf_dims(data_path)
    exit_unrecognized()


def read_packed_rows(data_path: str, start: int, end: int, M: int,
                     grid) -> np.ndarray:
    """Packed rows [start, end) of a BED, PGEN or VCF, validated and
    minor-allele flipped by the code counts of every data row (the JAX
    package's multi-process input path, train/run.py:117-160)."""
    from .io.bed import flip_packed_minor_allele, rezero_flip_padding
    fmt = input_format(data_path)
    if fmt == "BED":
        from .io.bed import read_bed_packed_rows as read_rows
    elif fmt == "PGEN":
        from .io.pgen import read_pgen_packed_rows as read_rows
    elif fmt == "VCF":
        from .io.vcf import read_vcf_packed_rows as read_rows
    else:
        exit_unrecognized()
    packed, counts_local = read_rows(data_path, start, end)
    counts = allsum_hosts(counts_local, grid)
    if not (counts[0] > 0 and (counts[2] > 0 or counts[3] > 0)):
        raise ValueError("Only biallelic SNPs are supported. Please make sure "
                         "multiallelic sites have been removed.")
    if (counts * np.arange(4)).sum() / max(1, counts.sum()) >= 1:
        packed = rezero_flip_padding(flip_packed_minor_allele(packed), M)
    return packed


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


def infer_q_mesh(params, packed: np.ndarray, N: int, ks: List[int],
                 batch_size: int, grid) -> List[np.ndarray]:
    """Q (N, k) for each k in sorted ``ks`` on a grid of ranks, on every
    rank: ``packed`` holds this data row's rows of
    :func:`rows_of_data_row`, at full width. The rank's SNP block stays in
    host memory and goes to the device chunk by chunk through a stager."""
    from .parallel.sharded_step import infer_q_sharded
    from .train.engine import check_snp_axis
    W = packed.shape[1]
    check_snp_axis(4 * W, grid.n_snp)
    start, end, _ = rows_of_data_row(N, grid)
    w_loc = W // grid.n_snp
    block = np.ascontiguousarray(
        packed[:end - start, grid.s * w_loc:(grid.s + 1) * w_loc])
    missing = torch.tensor([int(packed_has_missing(block))],
                           device=grid.comm_device)
    grid.psum_(missing, (DATA_AXIS, SNP_AXIS), "has_missing")
    model = params_from_numpy(shard_params(params, grid.n_snp, grid.s), ks,
                              device=grid.device)
    qs = infer_q_sharded(model, grid, block, end - start, batch_size,
                         int(missing.item()) == 0)
    return [qs[hk] for hk in head_keys(ks)]


def rows_of_data_row(N: int, grid) -> Tuple[int, int, int]:
    """(start, end, rows_per_process) of this rank's data row in
    inference (no sampling quantum)."""
    return host_sample_shard(N, grid.n_data, 1, grid.d, grid.n_data)


def _resolve_infer_mesh(args, hosts=None) -> Optional[Tuple[int, int]]:
    """(n_data, n_snp) from --mesh 'DxS', else --num_gpus N > 1 (or several
    hosts) all data-parallel, else None: one device (the JAX package's
    _resolve_infer_mesh)."""
    n_hosts = hosts.count if hosts else 1
    if getattr(args, "mesh", None):
        n_data, n_snp = (int(v) for v in args.mesh.lower().split("x"))
        return ((n_data, n_snp) if n_data * n_snp > 1 or n_hosts > 1
                else None)
    n = n_hosts * max(1, int(args.num_gpus))
    return (n, 1) if n > 1 else None


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


def _fit_params(params, from_torch: bool, trained_m, M: int):
    """Check the data's M against the model's and pad a reference .pt's V to
    the packed lane multiple; returns the params."""
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
    return params


def _fit_width(packed: np.ndarray, params) -> np.ndarray:
    """The packed rows widened with zero columns to V's rows."""
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
    return packed


def _write_qs(Qs, ks: List[int], out_name: str, save_dir: str) -> None:
    if len(ks) == 1:
        write_outputs(Qs, out_name, ks[0], None, None, save_dir)
    elif ks == list(range(ks[0], ks[-1] + 1)):
        write_outputs(Qs, out_name, None, ks[0], ks[-1], save_dir)
    else:
        # Non-contiguous K list: write each K by name.
        for i, k in enumerate(ks):
            write_outputs([Qs[i]], out_name, k, None, None, save_dir)


def _infer_rank(grid, args, params, ks: List[int], N: int, M: int,
                t0: float) -> None:
    """One rank of a grid's ``infer``: read this data row's rows, the
    sharded pass, rank 0 writes."""
    start, end, _ = rows_of_data_row(N, grid)
    log.info(f"    Rank {grid.rank} of a {grid.n_data}x{grid.n_snp} grid "
             f"(data row {grid.d}, SNP block {grid.s}): this one holds rows "
             f"[{start}, {end}).")
    if not is_master():
        log.setLevel("WARNING")
    packed = _fit_width(read_packed_rows(args.data_path, start, end, M, grid),
                        params)
    log.info("    Running inference...")
    Qs = infer_q_mesh(params, packed, N, ks, int(args.batch_size), grid)
    if is_master():
        log.info("    Inference run successfully! Writing outputs...!")
        _write_qs(Qs, ks, args.out_name, args.save_dir)
        log.info("")
        log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
        log.info("")


def main_infer(args, t0: float, hosts=None) -> int:
    setup_logging()
    shape = _resolve_infer_mesh(args, hosts)
    if shape is None:
        device = select_device(int(args.num_gpus))

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
    # Qs come back in ascending-K order; sort the config's list the same way
    # so file names match their contents.
    ks = sorted(int(k) for k in config["ks"])

    if shape is not None:
        N, M = input_dims(args.data_path)
        params = _fit_params(params, from_torch, config.get("num_snps"), M)
        n_local = shape[0] * shape[1] // (hosts.count if hosts else 1)
        devices, backend = grid_devices(int(args.num_gpus), shape, n_local,
                                        "inference")
        spawn_grid(_infer_rank, *shape, devices, backend,
                   args=(args, params, ks, N, M, t0), hosts=hosts,
                   threads=int(args.threads))
        return 0

    packed, N, M = read_packed(args.data_path)
    params = _fit_params(params, from_torch, config.get("num_snps"), M)
    packed = _fit_width(packed, params)

    log.info("    Running inference...")
    Qs = infer_q(params, packed, N, ks, int(args.batch_size), device)
    log.info("    Inference run successfully! Writing outputs...!")
    _write_qs(Qs, ks, args.out_name, args.save_dir)

    log.info("")
    log.info(f"    Total elapsed time: {time.time() - t0:.2f} seconds.")
    log.info("")
    return 0
