"""Deterministic seeding of the global generators (numpy, random, torch).

Code that draws random numbers takes an explicit ``torch.Generator`` or
``np.random.default_rng(seed)``; ``set_seed`` covers the CLI's ``--seed``
for anything that still reads the global generators.
"""
import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
