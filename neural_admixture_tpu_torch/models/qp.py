"""The Q_P autoencoder's encoder as an ``nn.Module``.

    X (B, M) dosage/2, missing -> 0
      -> X @ V                 V: (M, D), from the RSVD at training
      -> RMSNorm(D, eps=1e-8)  (learnable scale, no bias)
      -> Linear(D -> H) + ReLU (shared encoder)
      -> per-K head Linear(H -> k) -> softmax  => Q_k (B, k)

Parameter names are those of the reference's torch state dict (``V``,
``batch_norm.weight``, ``common_encoder.0.*``, ``multihead_encoder.heads.{i}.*``
with ``i`` over sorted ks), so a reference ``.pt`` loads with
``load_state_dict``. The numpy parameter dict of the JAX package and of the
``.npz`` checkpoints (kernels stored (in, out)) loads through
:func:`params_from_numpy`.
"""
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..ops.fused_step import fused_infer_q

RMSNORM_EPS = 1e-8


def head_keys(ks: List[int]) -> List[str]:
    return [f"k{k}" for k in sorted(ks)]


class _MultiHead(nn.Module):
    def __init__(self, hidden: int, ks: List[int]):
        super().__init__()
        self.heads = nn.ModuleList(nn.Linear(hidden, k) for k in ks)


class QPEncoder(nn.Module):
    """V, RMSNorm, the shared Linear + ReLU and one Linear + softmax per K.

    Built without drawing random numbers: the parameters are uninitialised
    until loaded (:func:`params_from_numpy` or ``load_state_dict``)."""

    def __init__(self, m_pad: int, n_components: int, hidden_size: int,
                 ks: List[int], device=None):
        super().__init__()
        self.ks = sorted(int(k) for k in ks)
        with torch.device("meta"):
            self.V = nn.Parameter(torch.empty(m_pad, n_components),
                                  requires_grad=False)
            self.batch_norm = nn.RMSNorm(n_components, eps=RMSNORM_EPS)
            self.common_encoder = nn.Sequential(
                nn.Linear(n_components, hidden_size), nn.ReLU())
            self.multihead_encoder = _MultiHead(hidden_size, self.ks)
        self.to_empty(device=device or "cpu")

    def encode_from_xp(self, Xp: torch.Tensor) -> Dict[str, torch.Tensor]:
        """PCA-space input (B, D) -> {head key: Q (B, k)}."""
        e = self.common_encoder(self.batch_norm(Xp))
        return {hk: torch.softmax(head(e), dim=-1)
                for hk, head in zip(head_keys(self.ks),
                                    self.multihead_encoder.heads)}

    def forward(self, packed: torch.Tensor, no_missing: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Packed (B, W) uint8 rows -> {head key: Q (B, k)}, through the xv
        kernel on the card (its plain version on the CPU)."""
        return fused_infer_q(self, packed, no_missing)


def params_from_numpy(params: Dict, ks: List[int], device=None) -> QPEncoder:
    """The JAX package's parameter dict of numpy arrays (``{"V": (M, D),
    "rmsnorm": {"weight"}, "common": {"kernel": (D, H), "bias"}, "heads":
    {"k3": {"kernel": (H, 3), "bias"}, ...}}``) -> a QPEncoder on
    ``device``. Kernels are stored (in, out) there and (out, in) here."""
    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.tensor(a.T if transpose else a)

    ks = sorted(int(k) for k in ks)
    m_pad, D = np.shape(params["V"])
    H = np.shape(params["common"]["kernel"])[1]
    sd = {"V": t(params["V"]),
          "batch_norm.weight": t(params["rmsnorm"]["weight"]),
          "common_encoder.0.weight": t(params["common"]["kernel"], True),
          "common_encoder.0.bias": t(params["common"]["bias"])}
    for i, hk in enumerate(head_keys(ks)):
        head = params["heads"][hk]
        sd[f"multihead_encoder.heads.{i}.weight"] = t(head["kernel"], True)
        sd[f"multihead_encoder.heads.{i}.bias"] = t(head["bias"])
    model = QPEncoder(m_pad, D, H, ks, device=device)
    model.load_state_dict(sd)
    return model
