"""Views, checks and decodes of the 2-bit packed rows.

Layout decision, for every kernel of the port: the kernels read the
row-major (N, W) uint8 packed matrix as it is, each row in natural SNP
order, as little-endian 32-bit words (16 SNPs each). The JAX package
reorders SNPs into a "planar" order and the rows into a tile-major array
(its ops/pack.py planar_perm, tiles_from_rows) so that Mosaic unpacks
without lane shuffles and reads contiguous DMAs. On Hopper a packed row is
already contiguous in device memory, so none of that is carried over: V, P
and every other SNP-indexed array stay in natural order, and nothing needs
undoing at a host boundary. Any reordering a kernel wants (for shared-memory
banks, say) happens inside the kernel.

A batch reaches a kernel in one of two forms: gathered, its own (B, W)
array; or indexed (K7), the resident (n_rows, W) array with an int32 vector
``blk_idx`` of sampled ``blk``-row blocks, batch row r being resident row
``blk_idx[r // blk] * blk + r % blk`` (:func:`batch_rows`). The plain
versions gather (:func:`gather_batch`) and then compute as for a gathered
batch; the kernels read the resident rows in place.
"""
from typing import Optional

import numpy as np
import torch


def unpack_genotypes(packed: torch.Tensor) -> torch.Tensor:
    """(..., W) uint8 -> (..., 4W) uint8 raw codes in {0, 1, 2, 3}, the
    input of the RSVD and the PCA projection (missing stays 3)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    g = (packed.unsqueeze(-1) >> shifts) & 3
    return g.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def packed_view_u32(packed: np.ndarray) -> np.ndarray:
    """(N, W) uint8 2-bit rows -> (N, W//4) little-endian uint32 words, the
    words the kernels read (word w of a row holds SNPs 16w .. 16w+15, SNP
    16w+b at bits 2b, 2b+1)."""
    if packed.shape[-1] % 4:
        raise ValueError(f"packed width {packed.shape[-1]} is not a multiple "
                         "of 4 bytes")
    return np.ascontiguousarray(packed).view("<u4")


def packed_has_missing(packed: np.ndarray, block_bytes: int = 1 << 24
                       ) -> bool:
    """Does any 2-bit code equal 3 (missing)?

    A byte holds a 0b11 pair iff ``b & (b >> 1) & 0b01010101`` is nonzero.
    Blocked by bytes (whole rows, about ``block_bytes`` a block) with early
    exit, so large matrices never make a full-size temporary: a block of a
    fixed row count is a gigabyte at M = 1M. Column padding is packed as 0
    and cannot alias 3. A False answer lets the kernels skip the
    missing -> 0 select."""
    b8 = np.ascontiguousarray(packed).view(np.uint8).reshape(
        packed.shape[0], -1)
    block_rows = max(1, block_bytes // max(1, b8.shape[1]))
    for i in range(0, b8.shape[0], block_rows):
        blk = b8[i:i + block_rows]
        if np.any(blk & (blk >> 1) & 0x55):
            return True
    return False


def batch_rows(blk_idx: torch.Tensor, blk: int) -> torch.Tensor:
    """The resident rows (int64) of an indexed batch, in batch order:
    ``blk_idx[r // blk] * blk + r % blk`` for r < len(blk_idx) * blk."""
    ar = torch.arange(blk, dtype=torch.int64, device=blk_idx.device)
    return (blk_idx.to(torch.int64)[:, None] * blk + ar).reshape(-1)


def gather_batch(packed: torch.Tensor, blk_idx: Optional[torch.Tensor],
                 blk: int) -> torch.Tensor:
    """The batch as its own array: ``packed`` itself when gathered
    (``blk_idx`` None), else the rows of :func:`batch_rows`."""
    if blk_idx is None:
        return packed
    return packed.index_select(0, batch_rows(blk_idx, blk))


def batch_size(packed: torch.Tensor, blk_idx: Optional[torch.Tensor],
               blk: int) -> int:
    """Rows of the batch that (``packed``, ``blk_idx``, ``blk``) describe,
    checking the block index: an int32 1-D tensor on ``packed``'s device,
    ``blk`` >= 1 and every block inside ``packed`` when it is on the CPU (on
    the card that check would wait for the device; the kernels trust it)."""
    if blk_idx is None:
        return packed.shape[0]
    if blk_idx.dtype != torch.int32 or blk_idx.dim() != 1 \
            or blk_idx.device != packed.device or \
            not blk_idx.is_contiguous():
        raise ValueError(f"blk_idx must be a contiguous 1-D int32 tensor on "
                         f"{packed.device}, got {blk_idx.dtype} "
                         f"{tuple(blk_idx.shape)} on {blk_idx.device}")
    if int(blk) < 1:
        raise ValueError(f"blk must be >= 1, got {blk}")
    if packed.device.type == "cpu" and blk_idx.numel() and (
            int(blk_idx.min()) < 0
            or (int(blk_idx.max()) + 1) * blk > packed.shape[0]):
        raise ValueError(f"blk_idx reaches outside the {packed.shape[0]} "
                         f"packed rows (blocks of {blk})")
    return blk_idx.numel() * int(blk)
