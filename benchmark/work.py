"""The algorithm's work in a training step, from its shapes alone, and the
least time an NVIDIA H100 could take for it.

Frozen with the benchmark: the counts describe the mathematics of Neural
ADMIXTURE's step, not any implementation of it, so a later kernel that
computes the same step another way reads against the same numbers.

A step on a batch of B rows, M real SNPs, the heads' widths ks and D
principal components:

  forward    xv     Xp = X @ V                    2 B M D
             plane  raw_k = q_k @ P_k, each head   2 B M k
  backward   plane  dq_k = draw_k @ P_k^T          2 B M k
                    dP_k = q_k^T @ draw_k          2 B M k
             dv     dV = X^T @ dXp                 2 B M D

(a multiply-add is 2 FLOP). The plane's per-element terms are the BCE
gradient of every (row, SNP, head column) and, on a logged step, its two
logarithms: one operation each. Bytes are each input read once and each
output written once: the packed codes at 2 bits a genotype, V, P, dP and dV
in fp32, q, dq, Xp and dXp in fp32. The encoder's products (B (D H + H k)
multiply-adds) are under 0.1% of the step and are not counted.

A bound is the LARGEST of three times (the work overlaps on the chip, so
the times are not added): products over the dense TF32 tensor-core rate
(the fastest rate that takes fp32 operands), per-element operations over
the fp32 CUDA-core rate, bytes over the HBM rate.
"""
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAKS = {
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes": 3.35e12,
}
PEAK_NAME = {"tf32_flops": "products", "fp32_flops": "per-element",
             "hbm_bytes": "bytes"}


@dataclass(frozen=True)
class Work:
    """Products (FLOP), per-element operations and bytes."""
    products: float = 0.0
    elementwise: float = 0.0
    bytes: float = 0.0

    def times(self) -> Dict[str, float]:
        """Seconds each term needs at its peak, by the peak's key."""
        return {"tf32_flops": self.products / PEAKS["tf32_flops"],
                "fp32_flops": self.elementwise / PEAKS["fp32_flops"],
                "hbm_bytes": self.bytes / PEAKS["hbm_bytes"]}


def bound(work: Work) -> Tuple[float, str]:
    """(seconds, the term that sets it): the largest of the three times."""
    t = work.times()
    key = max(t, key=t.get)
    return t[key], PEAK_NAME[key]


def packed_bytes(B: int, M: int) -> float:
    return B * M / 4.0


def xv_work(B: int, M: int, D: int) -> Work:
    return Work(products=2.0 * B * M * D,
                bytes=packed_bytes(B, M) + 4.0 * M * D + 4.0 * B * D)


def dv_work(B: int, M: int, D: int) -> Work:
    return Work(products=2.0 * B * M * D,
                bytes=packed_bytes(B, M) + 4.0 * B * D + 4.0 * M * D)


def plane_work(B: int, M: int, ks: Iterable[int], logged: bool) -> Work:
    """The decoder plane of one step, every head: raw, dq, dP; the BCE
    gradient (and, logged, its two logarithms) of each element; the packed
    batch read once, each P read and each dP written once, q read and dq
    written once (a loss value is 4 bytes)."""
    sk = float(sum(ks))
    per_elem = 3.0 if logged else 1.0
    return Work(products=3 * 2.0 * B * M * sk,
                elementwise=per_elem * B * M * sk,
                bytes=(packed_bytes(B, M) + 2 * 4.0 * M * sk
                       + 2 * 4.0 * B * sk + (4.0 if logged else 0.0)))


def step_model_flops(B: int, M: int, D: int, ks: Iterable[int]) -> float:
    """The step's model FLOP: forward xv and raw, backward dq, dP and dV."""
    sk = float(sum(ks))
    return 2.0 * B * M * (2 * D + 3 * sk)


def layer_work(layer: str, B: int, M: int, D: int, ks: Iterable[int],
               logged: bool) -> Work:
    """One step's work of ``layer``: "plane", "xv" or "dv"."""
    if layer == "plane":
        return plane_work(B, M, ks, logged)
    if layer == "xv":
        return xv_work(B, M, D)
    if layer == "dv":
        return dv_work(B, M, D)
    raise ValueError(f"no work count for layer {layer!r}")


def period_bound(steps: List[Tuple[int, bool]], M: int, D: int,
                 ks: Iterable[int], layer: str) -> float:
    """Seconds: the sum over the steps ((rows, logged) each) of each step's
    bound for ``layer``. A step is bounded alone, since steps run one after
    another."""
    ks = list(ks)
    return sum(bound(layer_work(layer, rows, M, D, ks, logged))[0]
               for rows, logged in steps)
