"""Chunked forward over all samples for full-data Q inference."""
from typing import Callable, Dict, List, Union

import numpy as np
import torch


def chunked_forward(fwd: Callable, data: Union[np.ndarray, torch.Tensor],
                    N: int, batch: int, device) -> Dict[str, np.ndarray]:
    """Run ``fwd(block) -> {head: (batch, k)}`` over the first N rows of
    ``data``.

    ``data`` is a host array (``infer``: rows are sliced on the host, so
    only one block lives on the device at a time, as the packed matrix may
    be larger than device memory) or a tensor already on ``device`` (the
    post-training pass over the resident rows: sliced in place, never
    copied back through host memory). The last block is zero-padded to
    ``batch`` rows (zero codes decode to x = 0) and its padded rows are
    cropped from the result."""
    chunks: Dict[str, List[np.ndarray]] = {}
    for i in range(0, N, batch):
        n_real = min(i + batch, N) - i
        if isinstance(data, torch.Tensor):
            blk = data[i:i + n_real].to(device)
            if n_real < batch:
                blk = torch.cat([blk, blk.new_zeros(batch - n_real,
                                                    *blk.shape[1:])])
        else:
            blk_np = data[i:i + n_real]
            if n_real < batch:
                pad = np.zeros((batch - n_real,) + blk_np.shape[1:],
                               blk_np.dtype)
                blk_np = np.concatenate([blk_np, pad], axis=0)
            blk = torch.from_numpy(np.ascontiguousarray(blk_np)).to(device)
        for hk, q in fwd(blk).items():
            chunks.setdefault(hk, []).append(q[:n_real].cpu().numpy())
    return {hk: np.concatenate(parts, axis=0) for hk, parts in chunks.items()}
