"""Chunked forward over all samples for full-data Q inference."""
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..io.stage import HostStager


def chunked_forward(fwd: Callable, data: Union[np.ndarray, torch.Tensor],
                    N: int, batch: int, device,
                    order: Optional[np.ndarray] = None,
                    stager: Optional[HostStager] = None
                    ) -> Dict[str, np.ndarray]:
    """Run ``fwd(block) -> {head: (batch, k)}`` over N rows of ``data``.

    ``data`` is a host array (``infer``, and the streamed trainer's Q pass:
    the rows reach the device through ``stager``, by default a new one, so
    only two blocks live on the device at a time, as the packed matrix may
    be larger than device memory), or a tensor already on ``device`` (the
    resident trainer's Q pass: sliced in place, never copied back through
    host memory). Host row ``order[r]`` is row r of the pass (default: row
    r). The last block is zero-padded to ``batch`` rows (zero codes decode
    to x = 0) and its padded rows are cropped from the result."""
    chunks: Dict[str, List[torch.Tensor]] = {}
    starts = range(0, N, batch)
    own = None  # a stager made here, closed here
    if isinstance(data, torch.Tensor):
        def blocks():
            for i in starts:
                blk = data[i:min(i + batch, N)].to(device)
                if blk.shape[0] < batch:
                    blk = torch.cat([blk, blk.new_zeros(
                        batch - blk.shape[0], *blk.shape[1:])])
                yield blk
        source = blocks()
    else:
        data = np.ascontiguousarray(data)
        rows = (np.arange(N, dtype=np.int64) if order is None
                else np.asarray(order, np.int64)[:N])
        jobs = (np.concatenate([rows[i:i + batch], np.full(
            max(0, i + batch - N), -1, np.int64)]) for i in starts)
        if stager is None:
            stager = own = HostStager(device, batch, data.shape[1])
        source = stager.batches(data, jobs)
    # Q stays on the device until the end: no wait on each block, so the
    # next block's copy overlaps this one's forward.
    for j, blk in enumerate(source):
        n_real = min(N - j * batch, batch)
        for hk, q in fwd(blk).items():
            chunks.setdefault(hk, []).append(q[:n_real])
    out = {hk: torch.cat(parts).cpu().numpy() for hk, parts in chunks.items()}
    if own is not None:
        own.close()
    return out
