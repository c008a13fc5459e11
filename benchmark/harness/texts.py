"""The general text generator that every traffic mix reads.

A length distribution is a data entry: ``{"median": m, "sigma": s, "min": a,
"max": b}`` in tokens, log-normal and clipped. A draw of ``n`` lengths is the
same multiset for every seed: the distribution's quantiles at ``(i + 0.5) /
n``, in an order that the seed shuffles. So two seeds ask for the same work
in another order, and so does every call of a mix drawn call by call. A
text is that many of the vocabulary's whole words, one token each, drawn
from the seed.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

from benchmark.reference.tokenizer import Tokenizer

_WORDS: list[str] | None = None


def words() -> list[str]:
    global _WORDS
    if _WORDS is None:
        _WORDS = Tokenizer().whole_words()
    return _WORDS


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` quantile lengths of ``dist``, ascending."""
    inv = NormalDist().inv_cdf
    mu = math.log(dist["median"])
    raw = [math.exp(mu + dist["sigma"] * inv((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(raw), dist["min"], dist["max"]).astype(np.int64)


def lengths(dist: dict, n: int, rng: np.random.Generator, groups: int = 1) -> np.ndarray:
    """``groups`` runs of ``n`` lengths, each the quantile multiset in its
    own order: every group (a call's worth of traffic) asks for the same
    work."""
    out = []
    for _ in range(groups):
        part = quantile_lengths(dist, n)
        rng.shuffle(part)
        out.append(part)
    return np.concatenate(out)


def texts(lens: np.ndarray, rng: np.random.Generator) -> list[str]:
    """One text of ``lens[i]`` whole words for each ``i``."""
    vocab = words()
    ids = rng.integers(0, len(vocab), int(lens.sum())).tolist()
    out, pos = [], 0
    for n in lens.tolist():
        out.append(" ".join(map(vocab.__getitem__, ids[pos:pos + n])))
        pos += n
    return out
