"""dv: dV = X^T @ dXp from 2-bit packed rows (kernel K5 of the port).

The CUDA kernel is ``csrc/dv.cu`` (its source note says which TPU kernel it
replaces, what bounds it on an H100, and how it is laid out). This module
holds its wrapper :func:`dv` and its plain PyTorch version :func:`dv_plain`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel, or
the wrapper raises. A batch is gathered (its own rows) or indexed (K7: the
resident rows and a block index, ops/pack.py). ``dv.launches`` counts the
launches on gathered batches, ``dv.indexed_launches`` those on indexed ones.
"""
import ctypes
from typing import Optional

import torch

from .fused import unpack_dosage
from .pack import batch_size, gather_batch

MAX_D = 32


def dv_plain(packed: torch.Tensor, dXp: torch.Tensor,
             chunk_snps: int = 65536, blk_idx: Optional[torch.Tensor] = None,
             blk: int = 1) -> torch.Tensor:
    """Plain version: gather an indexed batch, then unpack ``chunk_snps``
    SNPs at a time (never the whole (B, 4W) fp32 X) and write
    ``x_chunk.T @ dXp`` into dV (4W, D)."""
    packed = gather_batch(packed, blk_idx, blk)
    B, W = packed.shape
    out = torch.empty(4 * W, dXp.shape[1], dtype=torch.float32,
                      device=dXp.device)
    cw = max(1, chunk_snps // 4)
    for w0 in range(0, W, cw):
        x = unpack_dosage(packed[:, w0:w0 + cw])
        out[4 * w0:4 * w0 + x.shape[1]] = x.T @ dXp
    return out


def _lib():
    from .. import _build
    lib = _build.load("dv")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.na_dv.argtypes = [vp, vp, vp, ll, ll, i, i, vp, i, vp]
    lib.na_dv.restype = i
    return lib


def rows_per_launch() -> int:
    """Batch rows that one launch of the kernel takes (their int8 pieces of
    dXp fill its shared memory); a larger batch takes several launches, each
    adding into dV in order. Needs the built kernel."""
    fn = _lib().na_dv_rows_per_launch
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _check(packed: torch.Tensor, dXp: torch.Tensor, B: int) -> None:
    if packed.device != dXp.device:
        raise ValueError(f"packed is on {packed.device} but dXp on "
                         f"{dXp.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if dXp.dtype != torch.float32 or dXp.dim() != 2:
        raise ValueError(f"dXp must be a 2-D float32 tensor, got "
                         f"{dXp.dtype} {tuple(dXp.shape)}")
    if dXp.shape[0] != B:
        raise ValueError(f"dXp has {dXp.shape[0]} rows but the batch {B}")
    if not 1 <= dXp.shape[1] <= MAX_D:
        raise ValueError(f"dv supports 1 <= D <= {MAX_D}, got "
                         f"D={dXp.shape[1]}")


def dv(packed: torch.Tensor, dXp: torch.Tensor, no_missing: bool = False,
       blk_idx: Optional[torch.Tensor] = None, blk: int = 1) -> torch.Tensor:
    """dV (4W, D) fp32 = X^T @ dXp, X the dosage/2 of the batch's packed
    rows with code 3 -> 0, dXp (B, D) fp32. The batch is ``packed`` (B, W)
    uint8, or with ``blk_idx`` (int32, B / blk blocks) the rows of the
    resident ``packed`` that it indexes, read in place on the card.

    ``no_missing``: the caller has checked that no code is 3
    (ops.pack.packed_has_missing); the kernel then skips the mask. The plain
    version masks anyway (the result is the same)."""
    B = batch_size(packed, blk_idx, blk)
    _check(packed, dXp, B)
    if packed.device.type == "cpu":
        return dv_plain(packed, dXp, blk_idx=blk_idx, blk=blk)
    if packed.device.type != "cuda":
        raise ValueError(f"dv runs on CPU or CUDA tensors, not "
                         f"{packed.device}")
    W = packed.shape[1]
    D = dXp.shape[1]
    if W % 4 or packed.data_ptr() % 4:
        raise ValueError(f"the dv kernel reads 32-bit words: packed width {W} "
                         "must be a multiple of 4 and rows 4-byte aligned")
    if not (packed.is_contiguous() and dXp.is_contiguous()):
        raise ValueError("dv needs contiguous packed and dXp")
    out = torch.empty(4 * W, D, dtype=torch.float32, device=dXp.device)
    if B == 0 or W == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.na_dv(packed.data_ptr(), dXp.data_ptr(), out.data_ptr(), B,
                        W, D, int(no_missing),
                        None if blk_idx is None else blk_idx.data_ptr(),
                        int(blk), stream)
    if err != 0:
        raise RuntimeError(f"dv kernel launch failed: CUDA error {err} "
                           f"(B={B}, W={W}, D={D})")
    if blk_idx is None:
        dv.launches += 1
    else:
        dv.indexed_launches += 1
    return out


dv.launches = 0
dv.indexed_launches = 0
