"""The Q_P autoencoder as ``nn.Module``s.

    X (B, M) dosage/2, missing -> 0
      -> X @ V                 V: (M, D), from the RSVD at training
      -> RMSNorm(D, eps=1e-8)  (learnable scale, no bias)
      -> Linear(D -> H) + ReLU (shared encoder)
      -> per-K head Linear(H -> k) -> softmax  => Q_k (B, k)
      -> per-K decoder Q_k @ P_k, P_k: (k, M), clamped to [0, 1] in the loss

:class:`QPEncoder` is the encoder (what ``infer`` loads); :class:`QPModel`
adds the decoders P_k for training. Parameter names are those of the
reference's torch state dict (``V``, ``batch_norm.weight``,
``common_encoder.0.*``, ``multihead_encoder.heads.{i}.*`` with ``i`` over
sorted ks; ``decoders.k{K}`` for P), so a reference ``.pt`` loads with
``load_state_dict``. The numpy parameter dict of the JAX package and of the
``.npz`` checkpoints (kernels stored (in, out), ``decoders`` (k, M)) moves
in and out through :func:`params_from_numpy` and :func:`params_to_numpy`.
"""
from typing import Dict, List, Optional, Tuple

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
    until loaded (:func:`params_from_numpy`, :func:`init_params` or
    ``load_state_dict``)."""

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
            self._build_decoders(m_pad)
        self.to_empty(device=device or "cpu")

    def _build_decoders(self, m_pad: int) -> None:
        """The encoder has none."""

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


class QPModel(QPEncoder):
    """The encoder plus the decoders ``decoders[f"k{K}"]`` (k, m_pad): the
    trainable model. V is trainable too (initialised from the RSVD)."""

    def _build_decoders(self, m_pad: int) -> None:
        self.V.requires_grad_(True)
        self.decoders = nn.ParameterDict(
            {hk: nn.Parameter(torch.empty(k, m_pad))
             for hk, k in zip(head_keys(self.ks), self.ks)})

    def forward_train(self, X: torch.Tensor):
        """Plain forward on an unpacked (B, m_pad) X: ({head: raw Q @ P
        before the clamp}, {head: Q}), as the JAX package's
        models/qp.py forward_train (the clamp lives in the loss)."""
        qs = self.encode_from_xp(X @ self.V)
        return {hk: q @ self.decoders[hk] for hk, q in qs.items()}, qs

    @torch.no_grad()
    def restrict_P(self) -> None:
        """Clamp every P into [0, 1] after an optimizer step, in place."""
        for P in self.decoders.values():
            P.clamp_(0.0, 1.0)


def state_dict_from_numpy(params: Dict,
                          ks: Optional[List[int]] = None) -> Dict:
    """The numpy parameter dict -> the state dict of a QPModel or, without
    ``decoders``, of a QPEncoder (the reference's key names), with the heads
    of ``ks`` (default: every head of ``params``)."""
    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.tensor(a.T if transpose else a)

    sd = {"V": t(params["V"]),
          "batch_norm.weight": t(params["rmsnorm"]["weight"]),
          "common_encoder.0.weight": t(params["common"]["kernel"], True),
          "common_encoder.0.bias": t(params["common"]["bias"])}
    if ks is None:
        ks = [int(hk[1:]) for hk in params["heads"]]
    for i, hk in enumerate(head_keys(ks)):
        head = params["heads"][hk]
        sd[f"multihead_encoder.heads.{i}.weight"] = t(head["kernel"], True)
        sd[f"multihead_encoder.heads.{i}.bias"] = t(head["bias"])
    for hk, P in params.get("decoders", {}).items():
        sd[f"decoders.{hk}"] = t(P)
    return sd


def params_from_numpy(params: Dict, ks: List[int], device=None) -> QPEncoder:
    """The JAX package's parameter dict of numpy arrays (``{"V": (M, D),
    "rmsnorm": {"weight"}, "common": {"kernel": (D, H), "bias"}, "heads":
    {"k3": {"kernel": (H, 3), "bias"}, ...}}`` and, for training,
    ``"decoders": {"k3": (3, M), ...}``) -> a QPEncoder on ``device``, or a
    QPModel when the dict has decoders. Kernels are stored (in, out) there
    and (out, in) here."""
    ks = sorted(int(k) for k in ks)
    m_pad, D = np.shape(params["V"])
    H = np.shape(params["common"]["kernel"])[1]
    cls = QPModel if "decoders" in params else QPEncoder
    model = cls(m_pad, D, H, ks, device=device)
    with torch.no_grad():
        model.load_state_dict(state_dict_from_numpy(params, ks))
    return model


def param_layout(model: QPEncoder) -> List[Tuple[str, nn.Parameter, bool]]:
    """(name in the JAX package's layout, "/"-separated, the parameter,
    whether that layout holds it transposed), for every parameter: V,
    rmsnorm/weight, common/kernel and bias, heads/k{K}/kernel and bias and,
    for a QPModel, decoders/k{K}."""
    common = model.common_encoder[0]
    out = [("V", model.V, False),
           ("rmsnorm/weight", model.batch_norm.weight, False),
           ("common/kernel", common.weight, True),
           ("common/bias", common.bias, False)]
    for hk, head in zip(head_keys(model.ks), model.multihead_encoder.heads):
        out += [(f"heads/{hk}/kernel", head.weight, True),
                (f"heads/{hk}/bias", head.bias, False)]
    if isinstance(model, QPModel):
        out += [(f"decoders/{hk}", P, False)
                for hk, P in model.decoders.items()]
    return out


def to_layout(t: torch.Tensor, transpose: bool) -> np.ndarray:
    """A tensor as a host fp32 array in the JAX package's layout."""
    t = t.detach().to("cpu", torch.float32)
    return (t.T if transpose else t).contiguous().numpy()


def from_layout(a: np.ndarray, transpose: bool) -> torch.Tensor:
    """The inverse of :func:`to_layout`, a contiguous CPU tensor."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def params_to_numpy(model: QPEncoder) -> Dict:
    """The inverse of :func:`params_from_numpy`: the JAX package's layout,
    as host numpy arrays."""
    out: Dict = {}
    for name, p, transpose in param_layout(model):
        *path, leaf = name.split("/")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = to_layout(p, transpose)
    return out


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int) -> Dict:
    """torch.nn.Linear's default init, as the JAX package's _linear_init:
    kernel (fan_in, fan_out) and bias, both U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), drawn in that order from ``gen``."""
    bound = 1.0 / np.sqrt(fan_in)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen, dtype=torch.float64)
                 * 2.0 - 1.0) * bound).to(torch.float32).numpy()

    return {"kernel": u(fan_in, fan_out), "bias": u(fan_out)}


def init_params(gen: torch.Generator, V: np.ndarray,
                P_init: Optional[np.ndarray], hidden_size: int,
                ks: List[int], m_pad: Optional[int] = None) -> Dict:
    """The initial parameter dict (numpy, the JAX package's layout), as the
    JAX package's models/qp.py init_params: V (M, D) from the RSVD and the
    decoders from ``P_init`` ((sum(ks), M), rows grouped per K ascending),
    both zero-padded on the SNP axis to ``m_pad``; RMSNorm scale 1; the
    linears drawn from the CPU generator ``gen`` (common, then the heads in
    ascending K). Padded P columns start at 0 and stay 0 under training,
    which makes the unmasked kernels exact on all-real batches."""
    ks = sorted(int(k) for k in ks)
    V = np.asarray(V, np.float32)
    M, D = V.shape
    m_tgt = max(m_pad or 0, M)
    Vp = np.zeros((m_tgt, D), np.float32)
    Vp[:M] = V
    params = {"V": Vp, "rmsnorm": {"weight": np.ones(D, np.float32)},
              "common": _linear_init(gen, D, hidden_size),
              "heads": {f"k{k}": _linear_init(gen, hidden_size, k)
                        for k in ks}}
    if P_init is not None:
        P_init = np.asarray(P_init, np.float32)
        params["decoders"] = {}
        start = 0
        for k in ks:
            Pk = np.zeros((k, m_tgt), np.float32)
            Pk[:, :M] = P_init[start:start + k]
            params["decoders"][f"k{k}"] = Pk
            start += k
    return params
