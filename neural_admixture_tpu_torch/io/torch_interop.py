"""Loading the reference implementation's torch ``.pt`` checkpoints.

The reference saves its trained model as a torch state dict with the decoder
(P) weights stripped. Its keys are the parameter names of
:class:`neural_admixture_tpu_torch.models.qp.QPEncoder`, so such a file also
loads straight into the encoder with ``load_state_dict``. This module maps it
onto the numpy parameter dict that the checkpoints, the writers and
``params_from_numpy`` share:

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
from typing import Dict, List

import numpy as np
import torch

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
