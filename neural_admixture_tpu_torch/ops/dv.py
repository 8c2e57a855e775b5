"""dv: dV = X^T @ dXp from 2-bit packed rows (kernel K5 of the port).

The CUDA kernel is ``csrc/dv.cu`` (its source note says which TPU kernel it
replaces, what bounds it on an H100, and how it is laid out). This module
holds its wrapper :func:`dv` and its plain PyTorch version :func:`dv_plain`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel, or
the wrapper raises. ``dv.launches`` counts the kernel launches.
"""
import ctypes

import torch

from .fused import unpack_dosage

MAX_D = 32


def dv_plain(packed: torch.Tensor, dXp: torch.Tensor,
             chunk_snps: int = 65536) -> torch.Tensor:
    """Plain version: unpack ``chunk_snps`` SNPs at a time (never the whole
    (B, 4W) fp32 X) and write ``x_chunk.T @ dXp`` into dV (4W, D)."""
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
    lib.na_dv.argtypes = [vp, vp, vp, ll, ll, i, i, vp]
    lib.na_dv.restype = i
    return lib


def _check(packed: torch.Tensor, dXp: torch.Tensor) -> None:
    if packed.device != dXp.device:
        raise ValueError(f"packed is on {packed.device} but dXp on "
                         f"{dXp.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if dXp.dtype != torch.float32 or dXp.dim() != 2:
        raise ValueError(f"dXp must be a 2-D float32 tensor, got "
                         f"{dXp.dtype} {tuple(dXp.shape)}")
    if dXp.shape[0] != packed.shape[0]:
        raise ValueError(f"dXp has {dXp.shape[0]} rows but packed "
                         f"{packed.shape[0]}")
    if not 1 <= dXp.shape[1] <= MAX_D:
        raise ValueError(f"dv supports 1 <= D <= {MAX_D}, got "
                         f"D={dXp.shape[1]}")


def dv(packed: torch.Tensor, dXp: torch.Tensor,
       no_missing: bool = False) -> torch.Tensor:
    """dV (4W, D) fp32 = X^T @ dXp, X the dosage/2 of ``packed`` (B, W)
    uint8 with code 3 -> 0, dXp (B, D) fp32.

    ``no_missing``: the caller has checked that no code is 3
    (ops.pack.packed_has_missing); the kernel then skips the mask. The plain
    version masks anyway (the result is the same)."""
    _check(packed, dXp)
    if packed.device.type == "cpu":
        return dv_plain(packed, dXp)
    if packed.device.type != "cuda":
        raise ValueError(f"dv runs on CPU or CUDA tensors, not "
                         f"{packed.device}")
    B, W = packed.shape
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
                        W, D, int(no_missing), stream)
    if err != 0:
        raise RuntimeError(f"dv kernel launch failed: CUDA error {err} "
                           f"(B={B}, W={W}, D={D})")
    dv.launches += 1
    return out


dv.launches = 0
