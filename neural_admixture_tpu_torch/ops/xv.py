"""xv: Xp = X @ V from 2-bit packed rows (kernel K2 of the port).

The CUDA kernel is ``csrc/xv.cu`` (its source note says which TPU kernel it
replaces, what bounds it on an H100, and how it is laid out). This module
holds its wrapper :func:`xv` and its plain PyTorch version :func:`xv_plain`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel, or
the wrapper raises. A batch is gathered (its own rows) or indexed (K7: the
resident rows and a block index, ops/pack.py). ``xv.launches`` counts the
launches on gathered batches, ``xv.indexed_launches`` those on indexed ones.
"""
import ctypes
from typing import Optional

import torch

from .fused import unpack_dosage
from .pack import batch_size, gather_batch

MAX_D = 32
# Blocks of 256 threads an SM that the kernel's D <= 8 instances fit
# (__launch_bounds__ in csrc/xv.cu; ptxas gives them 108-110 registers).
BLOCKS_PER_SM = 2


def xv_plain(packed: torch.Tensor, V: torch.Tensor, chunk_snps: int = 65536,
             blk_idx: Optional[torch.Tensor] = None, blk: int = 1
             ) -> torch.Tensor:
    """Plain version: gather an indexed batch, then unpack ``chunk_snps``
    SNPs at a time (never the whole (B, 4W) fp32 X) and accumulate
    ``x_chunk @ V_chunk``."""
    packed = gather_batch(packed, blk_idx, blk)
    B, W = packed.shape
    out = torch.zeros(B, V.shape[1], dtype=torch.float32, device=V.device)
    cw = max(1, chunk_snps // 4)
    for w0 in range(0, W, cw):
        x = unpack_dosage(packed[:, w0:w0 + cw])
        out += x @ V[4 * w0:4 * w0 + x.shape[1]]
    return out


def _lib():
    from .. import _build
    lib = _build.load("xv")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.na_xv.argtypes = [vp, vp, vp, vp, ll, ll, i, i, i, vp, i, vp]
    lib.na_xv.restype = i
    lib.na_xv_rows_per_block.argtypes = [i]
    lib.na_xv_rows_per_block.restype = i
    lib.na_xv_chunks.argtypes = [ll]
    lib.na_xv_chunks.restype = ll
    return lib


def split_count(lib, B: int, W: int, D: int, sms: int) -> int:
    """Blocks of a launch of the kernel: each owns a range of 512-SNP
    chunks and every row of the launch (``na_xv_rows_per_block(D)`` rows;
    a larger batch takes several launches). About BLOCKS_PER_SM blocks an
    SM, but no split without a chunk of its own."""
    return max(1, min(lib.na_xv_chunks(W), BLOCKS_PER_SM * sms))


def _check(packed: torch.Tensor, V: torch.Tensor) -> None:
    if packed.device != V.device:
        raise ValueError(f"packed is on {packed.device} but V on {V.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if V.dtype != torch.float32 or V.dim() != 2:
        raise ValueError(f"V must be a 2-D float32 tensor, got {V.dtype} "
                         f"{tuple(V.shape)}")
    B, W = packed.shape
    if V.shape[0] != 4 * W:
        raise ValueError(f"V has {V.shape[0]} rows but packed rows hold "
                         f"{4 * W} SNPs")
    if not 1 <= V.shape[1] <= MAX_D:
        raise ValueError(f"xv supports 1 <= D <= {MAX_D}, got D={V.shape[1]}")


def xv(packed: torch.Tensor, V: torch.Tensor, no_missing: bool = False,
       blk_idx: Optional[torch.Tensor] = None, blk: int = 1) -> torch.Tensor:
    """Xp (B, D) fp32 = X @ V, X the dosage/2 of the batch's packed rows
    with code 3 -> 0, V (4W, D) fp32. The batch is ``packed`` (B, W) uint8,
    or with ``blk_idx`` (int32, B / blk blocks) the rows of the resident
    ``packed`` that it indexes, read in place on the card.

    ``no_missing``: the caller has checked that no code is 3
    (ops.pack.packed_has_missing); the kernel then skips the mask. The plain
    version masks anyway (the result is the same)."""
    _check(packed, V)
    B = batch_size(packed, blk_idx, blk)
    if packed.device.type == "cpu":
        return xv_plain(packed, V, blk_idx=blk_idx, blk=blk)
    if packed.device.type != "cuda":
        raise ValueError(f"xv runs on CPU or CUDA tensors, not "
                         f"{packed.device}")
    W = packed.shape[1]
    D = V.shape[1]
    if W % 4 or packed.data_ptr() % 4:
        raise ValueError(f"the xv kernel reads 32-bit words: packed width "
                         f"{W} must be a multiple of 4 and rows 4-byte "
                         "aligned")
    if not (packed.is_contiguous() and V.is_contiguous()):
        raise ValueError("xv needs contiguous packed and V")
    out = torch.empty(B, D, dtype=torch.float32, device=V.device)
    if B == 0 or W == 0:
        return out.zero_()
    lib = _lib()
    n_split = split_count(lib, B, W, D, torch.cuda.get_device_properties(
        packed.device).multi_processor_count)
    partial = torch.empty(n_split, B, D, dtype=torch.float32,
                          device=V.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.na_xv(packed.data_ptr(), V.data_ptr(), partial.data_ptr(),
                        out.data_ptr(), B, W, D, n_split, int(no_missing),
                        None if blk_idx is None else blk_idx.data_ptr(),
                        int(blk), stream)
    if err != 0:
        raise RuntimeError(f"xv kernel launch failed: CUDA error {err} "
                           f"(B={B}, W={W}, D={D}, n_split={n_split})")
    if blk_idx is None:
        xv.launches += 1
    else:
        xv.indexed_launches += 1
    return out


xv.launches = 0
xv.indexed_launches = 0
