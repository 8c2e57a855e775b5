"""P initialisation (the JAX package's train/init.py).

Unsupervised:
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

Supervised (one K): the labels, sorted by name, become 0..K-1
(:func:`encode_populations`), and P_k's row c is the mean RAW code of the
rows labelled c, missing (3) included, as the reference does
(:func:`init_p_supervised_packed`, on the packed rows' device;
:func:`init_p_supervised` from a dense (N, M) matrix on the host).

Over the data rows of a grid of ranks (``rows`` = (start, end) and
``grid``; the JAX package's multi-host ``rows``, train/init.py:116-124,
:176-182): the packed rows are this data row's; its PCA coordinates are
gathered over the data group and every rank fits the same GMM, and the
supervised sums and counts are summed over it.

The packed rows are a tensor on the device that computes, or a host array
with that ``device``: uploaded once, or with ``stream`` read block by block
through the stager (io/stage.py; the JAX package's host-streamed
projection, train/init.py:46-89); ``stream=None`` streams when the packed
rows would not fit the device (its estimate, train/init.py:63). The blocks
and their order do not change with ``stream``, so neither does any result.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.stage import PackedRows
from ..ops.gmm import fit_gmm
from ..ops.pack import unpack_genotypes
from ..ops.rsvd import block_rows_for
from ..parallel.distributed import allsum_hosts, gather_ragged_rows
from ..utils.seeding import generator


def project_pca(packed, V: np.ndarray, N: int, block_bytes: int = 1 << 30,
                device=None, stream=None, gather_threads=None
                ) -> torch.Tensor:
    """(N, D) = (G/2) @ V^T of the packed rows (N, W) uint8 and V (D, M),
    on the packed rows' device (``device`` for a host array; streamed, its
    stager gathers on ``gather_threads`` threads)."""
    m_pad = 4 * packed.shape[1]
    src = PackedRows(packed, N, block_rows_for(m_pad, block_bytes), device,
                     stream, gather_threads=gather_threads)
    dev = src.device
    V = np.asarray(V, np.float32)
    Vt = torch.zeros(m_pad, V.shape[0], dtype=torch.float32, device=dev)
    Vt[:V.shape[1]] = torch.from_numpy(np.ascontiguousarray(V.T)).to(dev)
    out = torch.empty(N, V.shape[0], dtype=torch.float32, device=dev)
    for i, blk in src.blocks():
        A = unpack_genotypes(blk).to(torch.float32) * 0.5
        out[i:i + blk.shape[0]] = A @ Vt
    return out


def pca_coords(packed, V: np.ndarray, N: int, device=None, stream=None,
               rows=None, grid=None) -> torch.Tensor:
    """The (N, D) PCA coordinates (G/2) @ V^T of all N rows, which
    :func:`init_p_unsupervised` clusters (the JAX package's pca_coords,
    train/init.py:91-108). They depend on the packed rows and V only, never
    on the seed, so several GMM seeds (``--init_restarts``) share one
    projection. ``rows``, ``grid``: ``packed`` holds rows [start, end) of a
    grid's data row; its coordinates are gathered over the data group."""
    start, end = rows if rows is not None else (0, N)
    x_pca = project_pca(packed, V, end - start, device=device, stream=stream,
                        gather_threads=(grid.gather_threads
                                        if grid is not None else None))
    if grid is not None:
        x_pca = torch.from_numpy(gather_ragged_rows(x_pca.cpu().numpy(),
                                                    grid))
    return x_pca


def init_p_unsupervised(packed, V: np.ndarray, N: int, M: int,
                        ks: List[int], seed: int,
                        x_pca: Optional[torch.Tensor] = None, device=None,
                        stream=None, rows=None, grid=None) -> np.ndarray:
    """GMM-based P init: (sum(ks), M) float32, rows per K ascending.
    ``x_pca``: the :func:`pca_coords` of the rows (``packed`` is then not
    read). ``rows``, ``grid``: ``packed`` holds rows [start, end) of a
    grid's data row (see the module docstring)."""
    if x_pca is None:
        x_pca = pca_coords(packed, V, N, device=device, stream=stream,
                           rows=rows, grid=grid)
    X = x_pca.detach().to("cpu", torch.float32)
    Vh = torch.from_numpy(np.asarray(V, np.float32))  # (D, M)
    blocks = []
    for K in sorted(ks):
        res = fit_gmm(X, K, generator(seed, K))
        blocks.append(torch.clamp(res.means @ Vh, 5e-6, 1.0 - 5e-6).numpy())
    return np.concatenate(blocks, axis=0)


def encode_populations(pops: Sequence[str], K: int
                       ) -> Tuple[np.ndarray, Dict[str, int]]:
    """String labels -> (int64 indices 0..K-1, {label: index}), the labels
    sorted by name (the JAX package's train/init.py encode_populations).
    Raises if the labels name other than K populations."""
    ancestry = {anc: i for i, anc in enumerate(sorted(np.unique(pops)))}
    if len(ancestry) != K:
        raise ValueError(f"Number of ancestries in training ground truth "
                         f"({len(ancestry)}) is not equal to the value of K "
                         f"({K})")
    return np.asarray([ancestry[p] for p in pops], dtype=np.int64), ancestry


def init_p_supervised(G: np.ndarray, y: np.ndarray, K: int) -> np.ndarray:
    """(K, M) float32: row c is the mean raw code (0..3, missing 3
    included) of the rows of the dense (N, M) uint8 ``G`` labelled c."""
    return np.vstack([G[y == idx, :].astype(np.float32).mean(axis=0)
                      for idx in range(K)])


def init_p_supervised_packed(packed, y: np.ndarray, K: int, M: int,
                             block_bytes: int = 1 << 30, device=None,
                             stream=None, rows=None, grid=None
                             ) -> np.ndarray:
    """(K, M) float32: row c is the mean raw code (0..3, missing 3
    included) over the packed rows (N, W) uint8 labelled c by ``y`` (N,).

    Runs on the packed rows' device (``device`` for a host array) in row
    blocks of about ``block_bytes`` of fp64 codes. The per-class sums are
    fp64 adds of small integers (``index_add_``), exact in any order and
    free of the TF32 setting. ``rows``, ``grid``: ``packed`` holds rows
    [start, end) of a grid's data row; ``y`` stays global."""
    if rows is not None:
        y = np.asarray(y)[rows[0]:rows[1]]
    N = len(y)
    src = PackedRows(packed, N, block_bytes // (8 * 4 * packed.shape[1]),
                     device, stream, gather_threads=(
                         grid.gather_threads if grid is not None else None))
    dev = src.device
    y_t = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    sums = torch.zeros(K, 4 * packed.shape[1], dtype=torch.float64,
                       device=dev)
    for i, blk in src.blocks():
        sums.index_add_(0, y_t[i:i + blk.shape[0]],
                        unpack_genotypes(blk).to(torch.float64))
    counts = torch.bincount(y_t, minlength=K).to(torch.float64)
    if grid is not None:
        sums = torch.from_numpy(allsum_hosts(sums.cpu().numpy(), grid))
        counts = torch.from_numpy(allsum_hosts(counts.cpu().numpy(), grid))
    means = sums[:, :M] / torch.clamp_min(counts[:, None], 1.0)
    return means.to(torch.float32).cpu().numpy()
