"""The final masked binomial log-likelihood of (Q, P) given the genotypes
(the JAX package's ops/loglikelihood.py, the reference's evaluator):

    logl = sum over (i, j) with G[i,j] != 3 of
           g * log(rec) + (2 - g) * log1p(-rec),
    rec = clip(Q_i . P_j, eps, 1 - eps),  g = clip(G[i,j], eps, 2 - eps),
    eps = 1e-6.

Missing genotypes ARE masked here, unlike in the training loss.
:func:`loglikelihood` is the host float64 formula, through the native host
library (native/bed_native.py, C++) at the default ``eps`` where it is
built, else its NumPy twin :func:`loglikelihood_numpy`.
:func:`loglikelihood_packed` feeds it from 2-bit packed rows, and above
``device_threshold`` genotypes evaluates fp32 blocks on a device instead,
accumulated in float64 on the host; the blocks reach the device through the
stager (io/stage.py), so the whole packed matrix is never uploaded.
"""
import numpy as np
import torch

from ..io.packed import unpack_2bit_rows
from ..io.stage import PackedRows
from .pack import unpack_genotypes
from .rsvd import block_rows_for

_EPS = 1e-6


def loglikelihood(G: np.ndarray, P: np.ndarray, Q: np.ndarray, K: int,
                  eps: float = _EPS, block: int = 2048) -> float:
    """G: (N, M) uint8, P: (M, K), Q: (N, K) -> the log-likelihood, in
    float64 on the host: natively at the default ``eps`` where the library
    is built (as the JAX package does), else through NumPy."""
    if eps == _EPS:
        from ..native import bed_native
        if bed_native.available():
            return bed_native.loglikelihood(np.asarray(G), P, Q, eps)
    return loglikelihood_numpy(G, P, Q, eps, block)


def loglikelihood_numpy(G: np.ndarray, P: np.ndarray, Q: np.ndarray,
                        eps: float = _EPS, block: int = 2048) -> float:
    """The NumPy twin of the native log-likelihood: the formula in float64,
    ``block`` rows at a time."""
    G = np.asarray(G)
    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    total = 0.0
    for i in range(0, G.shape[0], block):
        g = G[i:i + block].astype(np.float64)
        rec = np.clip(Q[i:i + block] @ P.T, eps, 1.0 - eps)
        gc = np.clip(g, eps, 2.0 - eps)
        term = gc * np.log(rec) + (2.0 - gc) * np.log1p(-rec)
        total += float(np.sum(np.where(g == 3.0, 0.0, term)))
    return total


def _device_block(g_u8: torch.Tensor, P: torch.Tensor, Q: torch.Tensor,
                  eps: float) -> float:
    g = g_u8.to(torch.float32)
    rec = torch.clamp(Q @ P.T, eps, 1.0 - eps)
    gc = torch.clamp(g, eps, 2.0 - eps)
    term = gc * torch.log(rec) + (2.0 - gc) * torch.log1p(-rec)
    return float(torch.where(g == 3.0, torch.zeros_like(term), term).sum())


def loglikelihood_packed(packed: np.ndarray, M: int, P, Q,
                         eps: float = _EPS, block: int = 2048,
                         device_threshold: float = 2e10,
                         device=None) -> float:
    """The log-likelihood from packed rows ``packed`` (N, W) uint8; P (M, K),
    Q (N, K).

    Up to ``device_threshold`` N*M genotypes, row blocks are unpacked on the
    host and reduced in float64 (the formula of :func:`loglikelihood`).
    Above it, blocks of about 1 GB of fp32 are streamed to ``device``
    (default: the CPU), unpacked and reduced there in fp32, each block's sum
    added in float64 on the host."""
    N = np.shape(Q)[0]
    packed = np.asarray(packed)
    if N * M > device_threshold:
        src = PackedRows(packed, N, block_rows_for(4 * packed.shape[1],
                                                   1 << 30),
                         device, stream=True)
        P32 = torch.from_numpy(np.asarray(P, np.float32)).to(src.device)
        Q32 = torch.from_numpy(np.asarray(Q, np.float32)).to(src.device)
        total = 0.0
        for i, blk in src.blocks():
            g = unpack_genotypes(blk)[:, :M]
            total += _device_block(g, P32, Q32[i:i + blk.shape[0]], eps)
        return total
    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    total = 0.0
    for i in range(0, N, block):
        G_blk = unpack_2bit_rows(packed[i:i + block], M)
        total += loglikelihood(G_blk, P, Q[i:i + block], P.shape[1], eps=eps,
                               block=block)
    return total
