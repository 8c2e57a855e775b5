"""Population-genetics summary metrics (a copy of the JAX package's
utils/metrics.py, which the port does not import).

Hudson's Fst between estimated populations, as the reference displays it
after training:

    Fst = mean((p1 - p2)^2) / (mean(p1*(1-p2) + p2*(1-p1)) + 1e-7)
"""
from typing import List

import numpy as np


def hudsons_fst(pop1: np.ndarray, pop2: np.ndarray) -> float:
    """Degenerate inputs (empty or non-finite P) give NaN instead of
    raising, so the end-of-run report survives them."""
    p1 = np.asarray(pop1, dtype=np.float64)
    p2 = np.asarray(pop2, dtype=np.float64)
    if p1.size == 0 or p2.size == 0:
        return float("nan")
    with np.errstate(all="ignore"):
        num = np.mean((p1 - p2) ** 2)
        den = np.mean(p1 * (1.0 - p2) + p2 * (1.0 - p1)) + 1e-7
        return float(num / den)


def fst_table(P: np.ndarray) -> List[str]:
    """The lower-triangular Fst table of a P matrix (M, K), as display
    lines in the reference's layout."""
    M, K = P.shape
    lines = []
    header = "\t".join([f"Pop{p}" for p in range(K - 1)])
    lines.append(f"                \t{header}")
    lines.append("            Pop0")
    for j in range(1, K):
        row = f"            Pop{j}"
        for l in range(j):
            row += f"\t{hudsons_fst(P[:, l], P[:, j]):0.3f}"
        lines.append(row)
    return lines
