"""Deterministic seeding (port of sskd_tpu/utils/seed.py).

The JAX package returns a ``jax.random`` key; the port returns a
``torch.Generator`` that callers pass wherever torch draws random numbers.
Host-side randomness (numpy, ``random``) is seeded as in the JAX package.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed python and numpy, and return a ``torch.Generator`` on ``device``
    seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
