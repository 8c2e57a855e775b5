"""The per-batch forward on packed rows: xv kernel, then the encoder.

Counterpart of the JAX package's ops/fused_step.py ``fused_infer_q``. The
(B, M) fp32 X never exists: the xv kernel reads the 2-bit words once and
hands the (B, D) projection to the small encoder.
"""
from typing import Dict

import torch

from .xv import xv


def fused_infer_q(encoder, packed: torch.Tensor, no_missing: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """``encoder`` is a models.qp.QPEncoder on ``packed``'s device; returns
    {head key: Q (B, k)}."""
    return encoder.encode_from_xp(xv(packed, encoder.V, no_missing))
