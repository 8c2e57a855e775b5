"""Output writers: .Q text files, config JSON, and ``.npz`` checkpoints.

The same file contracts as the JAX package, so a model saved by either
package loads in the other:
  * ``{name}.{K}.Q`` / ``{name}.{K}.P`` space-delimited text, one file per K;
  * ``{name}_config.json`` with keys {ks, num_features, hidden_size,
    activation} and the optional ``num_snps`` (the trained M);
  * ``{name}.npz``: the parameter dict flattened with "/" separators
    ("V", "rmsnorm/weight", "common/kernel", "heads/k7/bias", ...), decoder
    (P) weights stripped.
"""
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils.logger import log, setup_logging


def _atomic_savetxt(path: Path, arr: np.ndarray) -> None:
    """Stage to .tmp then rename, so a crash mid-write never leaves a
    truncated matrix where a consumer will read it."""
    tmp = path.with_name(path.name + ".tmp")
    np.savetxt(tmp, arr, delimiter=" ")
    os.replace(tmp, path)


def write_outputs(Qs: List[np.ndarray], run_name: str, K: Optional[int],
                  min_k: Optional[int], max_k: Optional[int], out_path: str,
                  Ps: Optional[List[np.ndarray]] = None) -> None:
    """Write one ``{run_name}.{k}.Q`` (and optionally ``.P``) per K, for a
    single ``K`` or the range ``min_k..max_k``; each file atomically."""
    setup_logging()
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    ks = [K] if K is not None else list(range(min_k, max_k + 1))
    for i, k in enumerate(ks):
        _atomic_savetxt(out / f"{run_name}.{k}.Q", Qs[i])
        if Ps is not None:
            _atomic_savetxt(out / f"{run_name}.{k}.P", Ps[i])
    what = "Q and P matrices" if Ps is not None else "Q matrices"
    log.info(f"    {what} written for K = "
             f"{', '.join(str(k) for k in ks)}.")


def save_config(name: str, save_dir: str, ks: List[int], num_features: int,
                hidden_size: int, activation: str = "relu",
                num_snps: Optional[int] = None) -> None:
    """``num_snps`` (the trained M) lets infer check that new data has the
    same SNP count; padded V alone cannot."""
    config = {
        "ks": list(ks),
        "num_features": int(num_features),
        "hidden_size": int(hidden_size),
        "activation": activation,
    }
    if num_snps is not None:
        config["num_snps"] = int(num_snps)
    path = Path(save_dir) / f"{name}_config.json"
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as fb:
        json.dump(config, fb)
    os.replace(tmp, path)
    log.info("    Configuration file saved.")


def load_config(name: str, save_dir: str) -> Dict:
    with open(Path(save_dir) / f"{name}_config.json", "r") as fb:
        return json.load(fb)


def _flatten(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{key}/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save_checkpoint(params: Dict, name: str, save_dir: str,
                    strip_decoders: bool = True) -> str:
    """Save a nested dict of numpy arrays to ``{save_dir}/{name}.npz``,
    without the decoder (P) weights unless ``strip_decoders`` is False."""
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    to_save = {k: v for k, v in params.items()
               if not (strip_decoders and k == "decoders")}
    flat = _flatten(to_save)
    path = Path(save_dir) / f"{name}.npz"
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return str(path)


def load_checkpoint(name: str, save_dir: str) -> Dict:
    path = Path(save_dir) / f"{name}.npz"
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)
