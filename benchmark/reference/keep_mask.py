"""The attention-dropout keep-mask, frozen here as the reference's own copy.

Philox4x32-10 keyed by ``(seed, b * heads + head)`` with the counter
``(col // 4, row, 0, 0)``; element ``(row, col)`` takes word ``col % 4`` of
the output and is kept when its top 24 bits, over 2^24, are at least ``p``.
The mask is a pure function of ``(seed, head, row, col)``, which is what a
training step's dropout on the attention probabilities draws. Computed on
int64 tensors, each 32 x 32 -> 64-bit product built from 16-bit halves.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (ll >> 16)
    return a_hi * m_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox(c0: torch.Tensor, c1: torch.Tensor, k0: int, k1: torch.Tensor) -> list[torch.Tensor]:
    c0, c1, k1 = torch.broadcast_tensors(c0, c1, k1)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = torch.full_like(c0, k0 & U32)
    k1 = k1.clone()
    for r in range(10):
        if r:
            k0 = (k0 + W0) & U32
            k1 = (k1 + W1) & U32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def keep_mask(seed: int, heads: int, length: int, p: float, device=None) -> torch.Tensor:
    """``[heads, length, length]`` booleans: True where the probability is
    kept."""
    l4 = (length + 3) // 4
    bh = torch.arange(heads, dtype=torch.int64, device=device)[:, None, None]
    row = torch.arange(length, dtype=torch.int64, device=device)[None, :, None]
    col4 = torch.arange(l4, dtype=torch.int64, device=device)[None, None, :]
    words = philox(col4, row, int(seed), bh)
    bits = torch.stack(words, dim=-1).reshape(heads, length, 4 * l4)[:, :, :length]
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0) >= p
