"""The dosage decode shared by every kernel, as plain PyTorch.

On the card this is the device function ``unpack_word`` of ``csrc/xv.cu``
(the counterpart of the JAX package's ops/fused.py ``_unpack_x``); this
module is its plain version, used by the kernels' plain versions on the CPU
and as their oracle on the card.
"""
import torch


def unpack_dosage(packed: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """(..., W) uint8 2-bit rows -> (..., 4W) float32 model input.

    x = g/2 for the 2-bit code g, and 0 for code 3 (missing), as the
    reference forward pass does (X.float()/2; X[X == 1.5] = 0). ``scale=False``
    returns the raw g (missing still 0); the xv kernel works on raw g and
    halves its sums once at the end, which is exact in fp32.
    """
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    g = (packed.unsqueeze(-1) >> shifts) & 3
    g = g.reshape(*packed.shape[:-1], packed.shape[-1] * 4)
    x = g.to(torch.float32)
    x = x.masked_fill(g == 3, 0.0)
    return x * 0.5 if scale else x
