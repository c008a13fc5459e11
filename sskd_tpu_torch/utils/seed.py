"""Deterministic seeding (port of sskd_tpu/utils/seed.py).

The JAX package returns a ``jax.random`` key and splits it with
``new_rng``; the port returns a ``torch.Generator`` that callers pass
wherever torch draws random numbers, and :func:`new_rng` makes ``n`` fresh
generators from it, each seeded by one draw of it. The streams are torch's
Philox or Mersenne Twister, not threefry: the same seed gives the same
generators in the port, not the JAX package's bits. Host-side randomness
(numpy, ``random``) is seeded as in the JAX package.
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


def new_rng(gen: torch.Generator, n: int = 2) -> list[torch.Generator]:
    """``n`` fresh generators on ``gen``'s device, each seeded by a draw of
    ``gen`` (which moves on): the counterpart of splitting a key."""
    seeds = torch.randint(2**62, (n,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]
