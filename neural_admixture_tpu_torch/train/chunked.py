"""Chunked forward over all samples for full-data Q inference."""
from typing import Callable, Dict, List

import numpy as np
import torch


def chunked_forward(fwd: Callable, data: np.ndarray, N: int, batch: int,
                    device) -> Dict[str, np.ndarray]:
    """Run ``fwd(block) -> {head: (batch, k)}`` over the N rows of ``data``.

    Rows are sliced on the host so that only one block lives on the device
    at a time (the packed matrix may be larger than device memory); the last
    block is zero-padded to ``batch`` rows (zero codes decode to x = 0) and
    its padded rows are cropped from the result."""
    chunks: Dict[str, List[np.ndarray]] = {}
    for i in range(0, N, batch):
        blk_np = data[i:min(i + batch, N)]
        n_real = blk_np.shape[0]
        if n_real < batch:
            pad = np.zeros((batch - n_real,) + blk_np.shape[1:], blk_np.dtype)
            blk_np = np.concatenate([blk_np, pad], axis=0)
        blk = torch.from_numpy(np.ascontiguousarray(blk_np)).to(device)
        for hk, q in fwd(blk).items():
            chunks.setdefault(hk, []).append(q[:n_real].cpu().numpy())
    return {hk: np.concatenate(parts, axis=0) for hk, parts in chunks.items()}
