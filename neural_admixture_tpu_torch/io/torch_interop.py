"""The reference implementation's torch ``.pt`` checkpoints, both ways.

The reference saves its trained model as a torch state dict with the decoder
(P) weights stripped. Its keys are the parameter names of
:class:`neural_admixture_tpu_torch.models.qp.QPEncoder`, so such a file also
loads straight into the encoder with ``load_state_dict``. This module maps it
onto the numpy parameter dict that the checkpoints, the writers and
``params_from_numpy`` share, and back:

    reference state-dict key              shape      dict entry          shape
    ------------------------------------  ---------  ------------------  ------
    V                                     (M, D)     V                   (M, D)
    batch_norm.weight                     (D,)       rmsnorm/weight      (D,)
    common_encoder.0.weight               (H, D)     common/kernel       (D, H)
    common_encoder.0.bias                 (H,)       common/bias         (H,)
    multihead_encoder.heads.{i}.weight    (k_i, H)   heads/k{K}/kernel   (H, k_i)
    multihead_encoder.heads.{i}.bias      (k_i,)     heads/k{K}/bias     (k_i,)

where ``i`` indexes ``sorted(ks)``.
"""
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.qp import state_dict_from_numpy

_HEAD_FMT = "multihead_encoder.heads.{i}.{p}"


def params_from_torch_state_dict(sd: Dict, ks: List[int]) -> Dict:
    """Decoder-stripped reference state dict -> numpy parameter dict."""
    def arr(key):
        v = sd[key]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v, dtype=np.float32)

    params = {
        "V": arr("V"),
        "rmsnorm": {"weight": arr("batch_norm.weight")},
        "common": {"kernel": arr("common_encoder.0.weight").T.copy(),
                   "bias": arr("common_encoder.0.bias")},
        "heads": {},
    }
    for i, k in enumerate(sorted(ks)):
        kernel = arr(_HEAD_FMT.format(i=i, p="weight")).T.copy()
        bias = arr(_HEAD_FMT.format(i=i, p="bias"))
        if kernel.shape[1] != k or bias.shape[0] != k:
            raise ValueError(
                f"Head {i} in the .pt file has K={kernel.shape[1]} but the "
                f"config lists ks[{i}]={k}; config and weights disagree.")
        params["heads"][f"k{k}"] = {"kernel": kernel, "bias": bias}
    return params


def load_pt_checkpoint(name: str, save_dir: str, ks: List[int]) -> Dict:
    """Load ``{save_dir}/{name}.pt`` (reference format) as a parameter dict."""
    path = Path(save_dir) / f"{name}.pt"
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(sd, ks)


def torch_state_dict_from_params(params: Dict,
                                 num_snps: Optional[int] = None) -> Dict:
    """Numpy parameter dict -> the reference's state dict, decoders
    stripped. ``num_snps``: the true SNP count; V's zero-padded rows beyond
    it are dropped, so the model has the reference's exact-M shapes."""
    sd = state_dict_from_numpy({k: v for k, v in params.items()
                                if k != "decoders"})
    if num_snps is not None:
        # a copy: torch.save would store the whole padded V behind a view
        sd["V"] = sd["V"][:int(num_snps)].clone()
    return sd


def save_pt_checkpoint(params: Dict, name: str, save_dir: str,
                       num_snps: Optional[int] = None) -> str:
    """Write ``{save_dir}/{name}.pt``, which the reference's infer loads."""
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    path = Path(save_dir) / f"{name}.pt"
    torch.save(torch_state_dict_from_params(params, num_snps), str(path))
    return str(path)
