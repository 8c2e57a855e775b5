"""bce_sum: the summed BCE of one head's decoder plane from 2-bit packed
rows (kernel K6 of the port), the loss value of the split program.

The CUDA kernel is ``csrc/bce_sum.cu`` (its source note says which TPU
kernel it replaces, what bounds it on an H100, and how it is laid out). This
module holds its wrapper :func:`bce_sum` and its plain PyTorch version
:func:`bce_sum_plain`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel, or
the wrapper raises. A batch is gathered (its own rows) or indexed (K7: the
resident rows and a block index, ops/pack.py). ``bce_sum.launches`` counts
the launches on gathered batches, ``bce_sum.indexed_launches`` those on
indexed ones.
"""
import ctypes
from typing import Optional

import torch

from .dq_dp import check_plane, launch_plan
from .fused import bce_elem, unpack_dosage
from .pack import gather_batch


def bce_sum_plain(packed: torch.Tensor, q: torch.Tensor, P: torch.Tensor,
                  col_mask: Optional[torch.Tensor],
                  row_w: Optional[torch.Tensor], masked: bool = True,
                  chunk_snps: int = 65536,
                  blk_idx: Optional[torch.Tensor] = None, blk: int = 1
                  ) -> torch.Tensor:
    """Plain version: the BCE sum (0-d), gathering an indexed batch and
    then unpacking ``chunk_snps`` SNPs at a time. Term for term and chunk
    for chunk the loss of ops/dq_dp.py ``dq_dp_plain(with_loss=True)``, so
    the split and merged programs log the same value on the CPU."""
    packed = gather_batch(packed, blk_idx, blk)
    B, W = packed.shape
    loss = torch.zeros((), dtype=torch.float32, device=q.device)
    cw = max(1, chunk_snps // 4)
    for w0 in range(0, W, cw):
        x = unpack_dosage(packed[:, w0:w0 + cw])
        cols = slice(4 * w0, 4 * w0 + x.shape[1])
        elem = bce_elem(torch.clamp(q @ P[:, cols], 0.0, 1.0), x)
        if masked:
            elem = elem * (col_mask[cols][None, :] * row_w[:, None])
        loss += elem.sum()
    return loss


def _lib():
    from .. import _build
    lib = _build.load("bce_sum")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.na_bce_sum.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ll, i, i, i,
                               i, vp, i, vp]
    lib.na_bce_sum.restype = i
    lib.na_bce_sum_tiles.argtypes = [ll, i]
    lib.na_bce_sum_tiles.restype = ll
    return lib


def bce_sum(packed: torch.Tensor, q: torch.Tensor, P: torch.Tensor,
            col_mask: Optional[torch.Tensor], row_w: Optional[torch.Tensor],
            masked: bool = True, no_missing: bool = False,
            blk_idx: Optional[torch.Tensor] = None, blk: int = 1
            ) -> torch.Tensor:
    """The summed BCE (a 0-d fp32 tensor) of clamp(q @ P, 0, 1) against
    x = dosage/2 of the batch's packed rows (code 3 -> 0): q (B, k), P
    (k, 4W), 1 <= k <= 16. The batch is ``packed`` (B, W) uint8, or with
    ``blk_idx`` (int32, B / blk blocks) the rows of the resident ``packed``
    that it indexes, read in place on the card. ``masked``: weight every
    element by col_mask[m] * row_w[b]; unmasked is exact for all-real rows
    whose padded P columns are 0. ``no_missing``: the caller has checked
    that no code is 3 (ops.pack.packed_has_missing); the kernel then skips
    the mask."""
    B = check_plane(packed, q, P, col_mask, row_w, masked, blk_idx, blk,
                    "bce_sum")
    if packed.device.type == "cpu":
        return bce_sum_plain(packed, q, P, col_mask, row_w, masked,
                             blk_idx=blk_idx, blk=blk)
    if packed.device.type != "cuda":
        raise ValueError(f"bce_sum runs on CPU or CUDA tensors, not "
                         f"{packed.device}")
    W = packed.shape[1]
    k = q.shape[1]
    if W % 4 or packed.data_ptr() % 4:
        raise ValueError(f"the bce_sum kernel reads 32-bit words: packed "
                         f"width {W} must be a multiple of 4 and rows 4-byte "
                         "aligned")
    tensors = [packed, q, P] + ([col_mask, row_w] if masked else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bce_sum needs contiguous inputs")
    loss = torch.zeros((), dtype=torch.float32, device=q.device)
    if B == 0 or W == 0:
        return loss
    lib = _lib()
    n_blocks = launch_plan(packed, lib.na_bce_sum_tiles(W, k))
    loss_part = torch.empty(n_blocks, dtype=torch.float32, device=q.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.na_bce_sum(
            packed.data_ptr(), q.data_ptr(), P.data_ptr(),
            col_mask.data_ptr() if masked else None,
            row_w.data_ptr() if masked else None, loss.data_ptr(),
            loss_part.data_ptr(), B, W, k, n_blocks, int(masked),
            int(no_missing), None if blk_idx is None else blk_idx.data_ptr(),
            int(blk), stream)
    if err != 0:
        raise RuntimeError(f"bce_sum kernel launch failed: CUDA error {err} "
                           f"(B={B}, W={W}, k={k}, n_blocks={n_blocks})")
    if blk_idx is None:
        bce_sum.launches += 1
    else:
        bce_sum.indexed_launches += 1
    return loss


bce_sum.launches = 0
bce_sum.indexed_launches = 0
