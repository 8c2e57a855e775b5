"""Each epoch's batches, drawn from the seed, in the form that
``launch_training``'s ``plans`` argument takes.

Batches sample whole blocks of ``sample_block`` consecutive resident rows
(the port's pre-shuffled rows). An epoch is nb - 1 full batches of
b_round rows and one remainder batch of b_rem rows that carries the rest:
the last data blocks, the partial block and the padding blocks. A plan is
(idx_full (nb - 1, b_round / blk), idx_rem (b_rem / blk,)) of block ids.
"""
from typing import List, Tuple

import numpy as np

Plan = Tuple[np.ndarray, np.ndarray]


def geometry(N: int, batch_size: int, blk: int) -> Tuple[int, int, int, int]:
    """(b_round, nb, b_rem, resident rows): batches of whole blocks."""
    if blk < 2:
        raise ValueError("the plans sample blocks of 2 or more rows")
    B = min(batch_size, N)
    b_round = -(-B // blk) * blk
    nb = -(-N // b_round)
    b_rem = -(-(N - (nb - 1) * b_round) // blk) * blk
    return b_round, nb, b_rem, (nb - 1) * b_round + b_rem


def epoch_plans(N: int, batch_size: int, blk: int, epochs: int,
                seed: int) -> List[Plan]:
    """``epochs`` plans: each epoch a permutation of the N // blk whole data
    blocks, every real row exactly once."""
    b_round, nb, _, n_rows = geometry(N, batch_size, blk)
    F = b_round // blk
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 4]))
    tail = np.arange(N // blk, n_rows // blk)
    out = []
    for _ in range(epochs):
        perm = rng.permutation(N // blk)
        out.append((perm[:(nb - 1) * F].reshape(nb - 1, F),
                    np.concatenate([perm[(nb - 1) * F:], tail])))
    return out


def batch_rows(block_ids: np.ndarray, blk: int) -> np.ndarray:
    """The resident rows of a batch of blocks, in batch order."""
    return (np.asarray(block_ids, np.int64)[:, None] * blk
            + np.arange(blk)).reshape(-1)


def pre_shuffle(N: int, train_seed: int) -> np.ndarray:
    """Resident row -> input row: the one-time row shuffle of block
    sampling, drawn from the training seed as the Neural ADMIXTURE CLI's
    port draws it (``np.random.default_rng(seed).permutation(N)``)."""
    return np.random.default_rng(int(train_seed)).permutation(N)
