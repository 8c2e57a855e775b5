"""Randomized SVD of the packed genotype matrix.

The JAX package's ops/rsvd.py ``rsvd``, with the same algorithm and numbers:
a Gaussian test matrix from ``np.random.default_rng(seed)`` (drawn exactly as
there), k' = max(k + oversampling, 20), 2 power iterations with QR
re-orthonormalisation, the dense SVD of B = Q^T A and the deterministic
sign flip. The raw genotype codes are the input, missing (3) included, as
in the reference.

The big products A @ Omega and Q^T @ A are ``torch.matmul`` on the device
over unpacked row blocks of at most ``block_bytes`` of fp32 each, a power
of two of rows (blocked by bytes, not rows: 4096 rows at M = 1M would be a
16 GB block); the (N, k') QR and the (k', M) SVD run on the host in NumPy,
as in the JAX package. Q^T @ A adds its blocks' fp32 products in float64
before it rounds B to fp32 (the JAX package sums in fp32), so B does not
depend on the order of that sum: on a grid whose data rows start on block
boundaries (a power of two divides them), every block's products are the
one-rank run's and so is V. Results do not depend on the block size except
for fp32 summation order.

Over the data rows of a grid of ranks (``rows`` and ``grid``; the JAX
package's multi-host ``rows``, ops/rsvd.py:98-200): ``packed`` holds this
data row's input rows [start, end); A @ Omega runs on them and the (N, k')
sketch is gathered over the data group, Q^T A is summed over it, so every
rank computes the same V with no broadcast.

Host streaming (the JAX package's ``stream``, ops/rsvd.py:51-63 and
:98-199): the packed rows stay in host memory and every product reads its
row blocks through the stager (io/stage.py), 2 + 2 * power_iterations
passes. The blocks, their order and the fp32 accumulation are the resident
path's, so a streamed V equals the resident V exactly.
"""
import numpy as np
import torch

from ..io.stage import PackedRows
from ..parallel.distributed import allsum_hosts, gather_ragged_rows
from .pack import unpack_genotypes


def svd_flip(V: np.ndarray, U: np.ndarray) -> np.ndarray:
    """Sign-normalise the rows of Vt by the dominant entries of U's
    columns (the reference's convention)."""
    U = np.asarray(U)
    V = np.asarray(V)
    idx = np.argmax(np.abs(U), axis=0)
    signs = np.sign(U[idx, np.arange(U.shape[1])])
    return V * signs[:, None]


def block_rows_for(m_pad: int, block_bytes: int) -> int:
    """Rows of an unpacked fp32 (rows, m_pad) block of ~``block_bytes``."""
    return max(1, block_bytes // max(1, 4 * m_pad))


def resident_bytes(n: int, W: int, k: int, oversampling: int = 10) -> int:
    """The JAX package's device footprint of a resident RSVD (its
    ops/rsvd.py:126-133): the packed rows plus the (m_pad, k') Omega and
    the (n, k') sketch."""
    kp = max(k + oversampling, 20)
    return n * W + (W * 4 + n) * kp * 4


def rsvd(packed, N: int, M: int, k: int = 8, seed: int = 42,
         oversampling: int = 10, power_iterations: int = 2,
         block_bytes: int = 1 << 30, device=None, stream=None,
         rows=None, grid=None) -> np.ndarray:
    """Randomized SVD of the packed genotypes. Returns Vt_k (k, M) float32.

    ``packed``: (N, W) uint8 (padding columns are genotype 0 and add
    nothing): a tensor on the device that runs the products, or a host
    array, whose products run on ``device`` (default the CPU): streamed
    with ``stream``, uploaded once without it; ``stream=None`` streams when
    :func:`resident_bytes` would not fit (utils/hbm.py). ``rows`` = (start,
    end) with ``grid``: ``packed`` holds only those of the N rows, and the
    data rows of the parallel.grid.Grid hold the rest."""
    W = packed.shape[1]
    m_pad = 4 * W
    start, end = rows if rows is not None else (0, N)
    n_local = end - start
    block_rows = 1 << (block_rows_for(m_pad, block_bytes).bit_length() - 1)
    src = PackedRows(packed, n_local, block_rows, device, stream,
                     resident_bytes(n_local, W, k, oversampling),
                     grid.gather_threads if grid is not None else None)
    dev = src.device
    k_prime = max(k + oversampling, 20)
    rng = np.random.default_rng(seed)
    Omega = np.zeros((m_pad, k_prime), np.float32)
    Omega[:M] = rng.standard_normal(size=(M, k_prime), dtype=np.float32)

    def A_omega(Om: np.ndarray) -> np.ndarray:
        """The whole Y = A @ Om (N, k'), on every rank."""
        Om_d = torch.from_numpy(np.ascontiguousarray(Om)).to(dev)
        Y = torch.empty(n_local, Om.shape[1], dtype=torch.float32,
                        device=dev)
        for i, blk in src.blocks():
            Y[i:i + blk.shape[0]] = unpack_genotypes(blk).to(
                torch.float32) @ Om_d
        return gather_ragged_rows(Y.cpu().numpy(), grid)

    def Qt_A(Q: np.ndarray) -> np.ndarray:
        """The whole B = Q^T A (k', m_pad), fp32, on every rank."""
        Qt = torch.from_numpy(np.ascontiguousarray(Q[start:end].T)).to(dev)
        B = torch.zeros(Q.shape[1], m_pad, dtype=torch.float64, device=dev)
        for i, blk in src.blocks():
            B += (Qt[:, i:i + blk.shape[0]] @ unpack_genotypes(blk).to(
                torch.float32)).double()
        return allsum_hosts(B.cpu().numpy(), grid).astype(np.float32)

    Y = A_omega(Omega)
    for _ in range(power_iterations):
        Q_y, _ = np.linalg.qr(Y, mode="reduced")
        Y = A_omega(Qt_A(Q_y).T)
    Q, _ = np.linalg.qr(Y, mode="reduced")
    B = Qt_A(Q)
    Ut, _St, Vt = np.linalg.svd(B[:, :M], full_matrices=False)
    Vt = svd_flip(Vt, Ut)
    return Vt[:k, :].astype(np.float32)
