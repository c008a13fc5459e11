"""Plain int8 row quantization and exact top-k over an index kept in blocks.

An index row is a unit vector stored as int8 values and one f32 scale:
``scale = absmax * f32(1 / 127)``, ``value = round_half_even(x / scale)``
clipped to [-127, 127]. A query is quantized the same way, and a row's score
is the exact integer dot product times both scales. The integer dots are
taken in float32 with TF32 off: every product and partial sum is an integer
below 2^24, so they are exact.
"""

from __future__ import annotations

import numpy as np
import torch


def unit_rows_host(rows: torch.Tensor) -> np.ndarray:
    """``rows`` normalized on the host as an index build normalizes its f32
    input (numpy float32 norms, divided row by row)."""
    emb = rows.float().cpu().numpy()
    norms = np.linalg.norm(emb, axis=1)
    return emb / np.maximum(norms[:, None], 1e-12)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scales = x.abs().amax(dim=1).clamp(min=1e-9) * (1.0 / 127.0)
    values = torch.clamp(torch.round(x / scales[:, None]), -127, 127)
    return values, scales  # values as exact f32 integers


class ExactTopK:
    """Running exact top-k of a few queries over blocks of rows, and the
    score of chosen rows."""

    def __init__(self, queries: torch.Tensor, k: int, watch: torch.Tensor):
        """``queries`` [Q, D] f32 embeddings; ``watch`` [Q, W] int64 rows
        whose scores to keep (the program's answers)."""
        self.qv, self.qs = quantize(queries)
        self.k = k
        self.watch = watch
        self.watch_scores = torch.full(watch.shape, float("nan"), device=queries.device)
        self.best = torch.full((queries.shape[0], k), -float("inf"), device=queries.device)
        self.best_ids = torch.full((queries.shape[0], k), -1, dtype=torch.int64,
                                   device=queries.device)

    def add_block(self, first_row: int, values: torch.Tensor, scales: torch.Tensor) -> None:
        dots = torch.matmul(self.qv, values.T)  # exact integers
        scores = dots * self.qs[:, None] * scales[None, :]
        n = values.shape[0]
        ids = torch.arange(first_row, first_row + n, device=values.device)
        cat_s = torch.cat([self.best, scores], dim=1)
        cat_i = torch.cat([self.best_ids, ids[None, :].expand(scores.shape[0], n)], dim=1)
        top, pos = torch.topk(cat_s, self.k, dim=1)
        self.best, self.best_ids = top, torch.gather(cat_i, 1, pos)
        inside = (self.watch >= first_row) & (self.watch < first_row + n)
        if inside.any():
            local = (self.watch - first_row).clamp(0, n - 1)
            got = torch.gather(scores, 1, local)
            self.watch_scores = torch.where(inside, got, self.watch_scores)
