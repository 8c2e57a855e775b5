"""P initialisation, unsupervised (the JAX package's train/init.py):
  1. project the genotypes onto the RSVD basis in row blocks, X_pca =
     (G/2) @ V^T, with missing genotypes NOT imputed (3/2 = 1.5 enters the
     projection, as in the reference);
  2. fit a full-covariance GMM per K in PCA space (ops/gmm.py);
  3. P_k = clip(means_k @ V, 5e-6, 1 - 5e-6), rows concatenated over K
     ascending.

The projection runs on the packed rows' device, blocked by bytes (about
1 GB of fp32 a block); the GMM runs on the host CPU in fp32 (N x D points,
a few hundred kilobytes), with its draws from a CPU ``torch.Generator``
seeded from (seed, K), so the card and the CPU start from the same seeding.
Supervised init waits for supervised mode (ROADMAP.md Queue 1 item 8).
"""
from typing import List, Optional

import numpy as np
import torch

from ..ops.gmm import fit_gmm
from ..ops.pack import unpack_genotypes
from ..ops.rsvd import block_rows_for
from ..utils.seeding import generator


def project_pca(packed: torch.Tensor, V: np.ndarray, N: int,
                block_bytes: int = 1 << 30) -> torch.Tensor:
    """(N, D) = (G/2) @ V^T of the packed rows (N, W) uint8 and V (D, M)."""
    dev = packed.device
    m_pad = 4 * packed.shape[1]
    V = np.asarray(V, np.float32)
    Vt = torch.zeros(m_pad, V.shape[0], dtype=torch.float32, device=dev)
    Vt[:V.shape[1]] = torch.from_numpy(np.ascontiguousarray(V.T)).to(dev)
    rows = block_rows_for(m_pad, block_bytes)
    out = torch.empty(N, V.shape[0], dtype=torch.float32, device=dev)
    for i in range(0, N, rows):
        A = unpack_genotypes(packed[i:i + rows]).to(torch.float32) * 0.5
        out[i:i + rows] = A @ Vt
    return out


def init_p_unsupervised(packed: torch.Tensor, V: np.ndarray, N: int, M: int,
                        ks: List[int], seed: int,
                        x_pca: Optional[torch.Tensor] = None) -> np.ndarray:
    """GMM-based P init: (sum(ks), M) float32, rows per K ascending.
    ``x_pca``: precomputed :func:`project_pca` coordinates."""
    if x_pca is None:
        x_pca = project_pca(packed, V, N)
    X = x_pca.detach().to("cpu", torch.float32)
    Vh = torch.from_numpy(np.asarray(V, np.float32))  # (D, M)
    blocks = []
    for K in sorted(ks):
        res = fit_gmm(X, K, generator(seed, K))
        blocks.append(torch.clamp(res.means @ Vh, 5e-6, 1.0 - 5e-6).numpy())
    return np.concatenate(blocks, axis=0)
