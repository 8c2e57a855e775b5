"""dq_dp: the BCE gradients of the decoder plane, with or without the BCE
value, from 2-bit packed rows (kernels K3 and K4 of the port).

The CUDA kernel is ``csrc/dq_dp.cu`` (its source note says which TPU
kernels it replaces, what bounds it on an H100, and how it is laid out).
This module holds its wrapper :func:`dq_dp` and its plain PyTorch version
:func:`dq_dp_plain`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel, or
the wrapper raises. A batch is gathered (its own rows) or indexed (K7: the
resident rows and a block index, ops/pack.py). ``dq_dp.launches`` counts the
kernel launches without the loss (K3) on gathered batches,
``dq_dp.loss_launches`` those with it (K4); ``indexed_launches`` and
``indexed_loss_launches`` count the same on indexed batches.
"""
import ctypes
from typing import Optional, Tuple

import torch

from .fused import draw_tile, unpack_dosage
from .pack import batch_size, gather_batch

MAX_K = 16


def dq_dp_plain(packed: torch.Tensor, q: torch.Tensor, P: torch.Tensor,
                col_mask: Optional[torch.Tensor],
                row_w: Optional[torch.Tensor], g=1.0,
                masked: bool = True, with_loss: bool = False,
                chunk_snps: int = 65536,
                blk_idx: Optional[torch.Tensor] = None, blk: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: (dq (B, k), dP (k, m_pad), loss or None), gathering an
    indexed batch and then unpacking ``chunk_snps`` SNPs at a time (never
    the whole (B, 4W) plane). dq is unscaled, dP carries the factor ``g``
    (the loss cotangent), as in the JAX package's _dq_dp_call; the loss is
    the BCE sum."""
    packed = gather_batch(packed, blk_idx, blk)
    B, W = packed.shape
    dq = torch.zeros(B, q.shape[1], dtype=torch.float32, device=q.device)
    dP = torch.empty_like(P)
    loss = torch.zeros((), dtype=torch.float32, device=q.device)
    cw = max(1, chunk_snps // 4)
    for w0 in range(0, W, cw):
        x = unpack_dosage(packed[:, w0:w0 + cw])
        cols = slice(4 * w0, 4 * w0 + x.shape[1])
        Pc = P[:, cols]
        mask_rw = (col_mask[cols][None, :] * row_w[:, None]) if masked \
            else None
        out = draw_tile(q, Pc, x, mask_rw, with_loss)
        draw, elem = out if with_loss else (out, None)
        dq += draw @ Pc.T
        dP[:, cols] = (q * g).T @ draw
        if with_loss:
            loss += elem.sum()
    return dq, dP, (loss if with_loss else None)


def _lib():
    from .. import _build
    lib = _build.load("dq_dp")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.na_dq_dp.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ll,
                             ll, i, i, i, i, i, vp, i, vp]
    lib.na_dq_dp.restype = i
    lib.na_dq_dp_tiles.argtypes = [ll, i]
    lib.na_dq_dp_tiles.restype = ll
    lib.na_dq_dp_rows.argtypes = [i]
    lib.na_dq_dp_rows.restype = i
    return lib


def check_plane(packed, q, P, col_mask, row_w, masked, blk_idx, blk,
                what="dq_dp") -> int:
    """Check the decoder-plane operands that dq_dp and bce_sum share and
    return the batch's rows B."""
    dev = packed.device
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    B = batch_size(packed, blk_idx, blk)
    W = packed.shape[1]
    for name, t in (("q", q), ("P", P)):
        if t.device != dev:
            raise ValueError(f"packed is on {dev} but {name} on {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if q.shape[0] != B or P.shape[1] != 4 * W or P.shape[0] != q.shape[1]:
        raise ValueError(f"shapes disagree: packed {tuple(packed.shape)}, q "
                         f"{tuple(q.shape)}, P {tuple(P.shape)} (want q "
                         "(B, k) and P (k, 4W))")
    if not 1 <= q.shape[1] <= MAX_K:
        raise ValueError(f"{what} supports 1 <= k <= {MAX_K}, got "
                         f"k={q.shape[1]}")
    if masked:
        for name, t, n in (("col_mask", col_mask, 4 * W), ("row_w", row_w, B)):
            if t is None or t.device != dev or t.dtype != torch.float32 \
                    or tuple(t.shape) != (n,):
                raise ValueError(f"masked {what} needs {name} as a float32 "
                                 f"({n},) tensor on {dev}")
    return B


def launch_plan(packed, tiles: int) -> int:
    """Blocks of a decoder-plane kernel: two per SM (the kernels' launch
    bounds), none without a tile."""
    sms = torch.cuda.get_device_properties(packed.device).multi_processor_count
    return int(max(1, min(tiles, 2 * sms)))


def dq_dp(packed: torch.Tensor, q: torch.Tensor, P: torch.Tensor,
          col_mask: Optional[torch.Tensor], row_w: Optional[torch.Tensor],
          g=1.0, masked: bool = True, no_missing: bool = False,
          with_loss: bool = False, blk_idx: Optional[torch.Tensor] = None,
          blk: int = 1
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dq (B, k), dP (k, 4W), loss or None) of the summed BCE of
    clamp(q @ P) against x = dosage/2 of the batch's packed rows (code 3
    -> 0): dq unscaled, dP times ``g``; the loss (a 0-d tensor) only with
    ``with_loss``. The batch is ``packed`` (B, W) uint8, or with ``blk_idx``
    (int32, B / blk blocks) the rows of the resident ``packed`` that it
    indexes, read in place on the card. ``masked``: weight every element by
    col_mask[m] * row_w[b]; unmasked is exact for all-real rows whose padded
    P columns are 0. ``g``: a float or a 0-d tensor (the loss cotangent, which the kernel
    reads on the device, so the backward never waits for it on the host).
    ``no_missing``: the caller has checked that no code is 3
    (ops.pack.packed_has_missing); the kernel then skips the mask."""
    B = check_plane(packed, q, P, col_mask, row_w, masked, blk_idx, blk)
    if packed.device.type == "cpu":
        return dq_dp_plain(packed, q, P, col_mask, row_w, g, masked,
                           with_loss, blk_idx=blk_idx, blk=blk)
    if packed.device.type != "cuda":
        raise ValueError(f"dq_dp runs on CPU or CUDA tensors, not "
                         f"{packed.device}")
    W = packed.shape[1]
    k = q.shape[1]
    if W % 4 or packed.data_ptr() % 4:
        raise ValueError(f"the dq_dp kernel reads 32-bit words: packed width "
                         f"{W} must be a multiple of 4 and rows 4-byte "
                         "aligned")
    tensors = [packed, q, P] + ([col_mask, row_w] if masked else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dq_dp needs contiguous inputs")
    dq = torch.empty(B, k, dtype=torch.float32, device=q.device)
    dP = torch.empty_like(P)
    loss = torch.zeros((), dtype=torch.float32, device=q.device)
    if B == 0 or W == 0:
        return dq.zero_(), dP.zero_(), (loss if with_loss else None)
    lib = _lib()
    n_blocks = launch_plan(packed, lib.na_dq_dp_tiles(W, k))
    rows = min(B, lib.na_dq_dp_rows(k))
    dq_part = torch.empty(n_blocks, rows, k, dtype=torch.float32,
                          device=q.device)
    loss_part = torch.empty(n_blocks, dtype=torch.float32, device=q.device)
    g_t = torch.as_tensor(g, dtype=torch.float32, device=q.device).reshape(())
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.na_dq_dp(
            packed.data_ptr(), q.data_ptr(), P.data_ptr(),
            col_mask.data_ptr() if masked else None,
            row_w.data_ptr() if masked else None, g_t.data_ptr(), dP.data_ptr(),
            dq.data_ptr(), loss.data_ptr(), dq_part.data_ptr(),
            loss_part.data_ptr(), B, W, k, n_blocks, int(masked),
            int(no_missing), int(with_loss),
            None if blk_idx is None else blk_idx.data_ptr(), int(blk), stream)
    if err != 0:
        raise RuntimeError(f"dq_dp kernel launch failed: CUDA error {err} "
                           f"(B={B}, W={W}, k={k}, n_blocks={n_blocks})")
    counter = "loss_launches" if with_loss else "launches"
    if blk_idx is not None:
        counter = "indexed_" + counter
    setattr(dq_dp, counter, getattr(dq_dp, counter) + 1)
    return dq, dP, (loss if with_loss else None)


dq_dp.launches = 0
dq_dp.loss_launches = 0
dq_dp.indexed_launches = 0
dq_dp.indexed_loss_launches = 0
