"""The plain PyTorch tile math that the kernels share.

On the card the decode is the device function ``unpack_word`` of
``csrc/unpack.cuh`` (the counterpart of the JAX package's ops/fused.py
``_unpack_x``), the BCE term is ``bce_term`` of ``csrc/bce.cuh`` (one
logarithm where ``bce_elem`` takes two, within 1e-6 relative) and the
draw is inlined in ``csrc/dq_dp.cu``; this module is their plain version, used by the kernels' plain versions on the
CPU and as their oracle on the card. Counterparts: ops/fused.py
``_bce_terms`` and ``_draw_tile`` of the JAX package, with fp32 operands and
exact division (the TPU's bf16 dot operands and approximate reciprocal are
not carried over).
"""
from typing import Optional

import torch

from .pack import unpack_genotypes

LOG_CLAMP = -100.0
GRAD_EPS = 1e-12


def unpack_dosage(packed: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """(..., W) uint8 2-bit rows -> (..., 4W) float32 model input.

    x = g/2 for the 2-bit code g, and 0 for code 3 (missing), as the
    reference forward pass does (X.float()/2; X[X == 1.5] = 0). ``scale=False``
    returns the raw g (missing still 0); the xv and dv kernels work on raw g
    and halve their sums once at the end, which is exact in fp32.
    """
    g = unpack_genotypes(packed)
    x = g.to(torch.float32).masked_fill(g == 3, 0.0)
    return x * 0.5 if scale else x


def bce_elem(rec: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with torch's -100 log clamp."""
    logr = torch.clamp_min(torch.log(rec), LOG_CLAMP)
    log1mr = torch.clamp_min(torch.log1p(-rec), LOG_CLAMP)
    return -(x * logr + (1.0 - x) * log1mr)


def draw_tile(q: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
              mask_rw: Optional[torch.Tensor], with_loss: bool = False):
    """d(loss)/d(raw) of one tile with torch's BCE + clamp backward:
    (rec - x) / max(rec (1 - rec), 1e-12) where 0 <= raw <= 1, else 0.
    With ``with_loss`` also the elementwise loss: returns (draw, elem)."""
    raw = q @ p
    rec = torch.clamp(raw, 0.0, 1.0)
    drec = (rec - x) / torch.clamp_min(rec * (1.0 - rec), GRAD_EPS)
    # raw == rec exactly on [0, 1]; NaN raws give 0 as well.
    draw = torch.where(raw == rec, drec, torch.zeros_like(drec))
    if mask_rw is not None:
        draw = draw * mask_rw
    if not with_loss:
        return draw
    elem = bce_elem(rec, x)
    if mask_rw is not None:
        elem = elem * mask_rw
    return draw, elem
