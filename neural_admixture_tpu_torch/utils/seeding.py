"""Deterministic seeding.

Code that draws random numbers takes an explicit CPU ``torch.Generator``
(from :func:`generator`) or ``np.random.default_rng(seed)``, so a run on the
card and a run on the CPU draw the same numbers; ``set_seed`` covers the
CLI's ``--seed`` for anything that still reads the global generators.
"""
import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of integers, e.g. (seed, K), via
    numpy's SeedSequence: distinct tuples give independent streams."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))
