"""Device-memory capacity heuristics shared by the out-of-core paths.

One source of truth for "does a host-resident array fit on the device": the
trainer's pre-flight estimate (train/engine.py), the RSVD (ops/rsvd.py), the
PCA projection and the supervised means (train/init.py) all budget against
the same capacity (the JAX package's utils/hbm.py, with the card's own
memory in place of the TPU runtime's report).
"""
import os

import torch

# Fraction of capacity a phase may plan to occupy; the rest is headroom for
# allocator fragmentation and scratch. Shared by every decision site so the
# phases agree on what "fits".
HBM_BUDGET_FRAC = 0.9


def hbm_capacity_bytes(device=None) -> float:
    """Memory of one device, in bytes.

    Priority: the NA_TPU_HBM_CAPACITY_GB override (GiB), then, on a CUDA
    ``device``, the card's own total memory, then 16 GiB (the JAX
    package's default; the CPU's case)."""
    env = os.environ.get("NA_TPU_HBM_CAPACITY_GB")
    if env:
        try:
            gb = float(env)
        except ValueError:
            raise ValueError(
                f"NA_TPU_HBM_CAPACITY_GB must be a number of GiB, got "
                f"{env!r}") from None
        if gb <= 0:
            raise ValueError(
                f"NA_TPU_HBM_CAPACITY_GB must be > 0, got {env!r}")
        return gb * 2**30
    if device is not None and torch.device(device).type == "cuda":
        return float(torch.cuda.get_device_properties(
            torch.device(device)).total_memory)
    return 16 * 2**30


def should_stream_host(nbytes: int, frac: float = HBM_BUDGET_FRAC,
                       device=None) -> bool:
    """True when a device-resident footprint of ``nbytes`` (the host array
    plus the op's own transients -- callers include them) should stream from
    host instead: it would claim more than ``frac`` of the capacity."""
    return nbytes > frac * hbm_capacity_bytes(device)
