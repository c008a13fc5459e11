"""Exact cosine/dot top-k over a device-resident corpus (port of
sskd_tpu/ops/topk.py, its exact engines).

Two engines, one contract: ``(scores [B, k] f32, indices [B, k] int32)``,
missing results ``(finfo(f32).min / 2, -1)``, rows ``>= valid_n`` never
returned, ties broken toward the lower row.

- The two-phase kernel engine (:mod:`sskd_tpu_torch.ops.topk_kernels`),
  taken on CUDA when :func:`kernel_exact_ok` holds.
- The blocked plain engine (:func:`cosine_topk_core`): ``torch.matmul`` per
  block of rows, ``torch.topk`` per block, one merge. It serves the CPU and
  the shapes the gate turns away, as the JAX package leaves those to XLA.

The approx engine (``method="approx"``) is not ported yet: it raises
``NotImplementedError`` and never falls back to exact in silence.
"""

from __future__ import annotations

import torch

from sskd_tpu_torch.ops.quant import quantize_rows, unpack_int4
from sskd_tpu_torch.ops.topk_kernels import (
    BIN_W,
    K_MAX,
    NEG_INF,
    cosine_topk_kernels,
    topk_stable,
)

APPROX_NOT_PORTED = (
    "method='approx' is not ported yet (ROADMAP Queue 1, 'approx engine': a "
    "bin-max with per-bin argmax standing in for lax.approx_max_k); use "
    "method='exact'"
)


def cosine_topk_core(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    block_rows: int = 262144,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
):
    """Blocked plain exact engine. ``corpus`` [N, D] f32 or int8, or [N, D/2]
    uint8 packed int4 (unpacked here, as the JAX package does off the
    kernel path). For int8 / int4 the queries are quantized per row and the
    integer dot is taken exactly, then ``* q_scale * row_scale``."""
    if corpus.dtype == torch.uint8:
        if row_scales is None:
            raise ValueError("packed int4 corpus requires row_scales")
        corpus = unpack_int4(corpus)
    B = queries.shape[0]
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    k_eff = max(1, min(k, n))
    block_rows = min(block_rows, max(128, n))
    quantized = corpus.dtype == torch.int8
    if quantized:
        if row_scales is None:
            raise ValueError("int8 corpus requires row_scales")
        q_int8, q_scale = quantize_rows(queries)
        q = q_int8.to(torch.float32)
    else:
        q = queries.to(torch.float32)

    parts_v, parts_i = [], []
    for lo in range(0, n, block_rows):
        hi = min(n, lo + block_rows)
        scores = corpus[lo:hi].to(torch.float32) @ q.T  # [R, B]; int dots exact
        scores = scores.T
        if quantized:
            scores = scores * q_scale[:, None] * row_scales[None, lo:hi]
        elif row_scales is not None:
            scores = scores * row_scales[None, lo:hi]
        if hi > valid_n:
            rows = torch.arange(lo, hi, device=corpus.device)
            scores = torch.where(rows[None, :] < valid_n, scores, NEG_INF)
        v, pos = topk_stable(scores, min(k_eff, hi - lo))
        parts_v.append(v)
        parts_i.append(pos + lo)
    vals, pos = topk_stable(torch.cat(parts_v, dim=1), k_eff)
    idx = torch.gather(torch.cat(parts_i, dim=1), 1, pos).to(torch.int32)
    if k_eff < k:  # pad out to the requested k
        vals = torch.cat([vals, vals.new_full((B, k - k_eff), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, k - k_eff), -1)], dim=1)
    idx = torch.where(vals > NEG_INF / 2, idx, -1)
    return vals, idx


def kernel_exact_ok(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> bool:
    """Gate of the two-phase kernel engine: a CUDA corpus, k within the
    kernels' capacity, and a corpus of more than 2 * k bins' rows (below that
    the rescan is no cheaper than a full sweep). Shapes the kernels cannot
    take past this gate make their wrappers raise."""
    return (
        corpus.device.type == "cuda"
        and corpus.dtype in (torch.float32, torch.int8, torch.uint8)
        and 1 <= k <= K_MAX
        and corpus.shape[0] > 2 * k * BIN_W
    )


def cosine_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    block_rows: int = 262144,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    method: str = "exact",
):
    """Top-k by ``queries @ corpus.T`` (cosine when both sides are
    L2-normalized, which the index builder guarantees). ``method`` must be
    ``"exact"``; see the module docstring for the engines."""
    if method == "approx":
        raise NotImplementedError(APPROX_NOT_PORTED)
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    if kernel_exact_ok(queries, corpus, k):
        return cosine_topk_kernels(queries, corpus, k, row_scales=row_scales, valid_n=valid_n)
    return cosine_topk_core(
        queries, corpus, k, block_rows=block_rows, row_scales=row_scales, valid_n=valid_n
    )


def merge_topk(scores: torch.Tensor, indices: torch.Tensor, k: int):
    """Merge candidate sets ``[B, M]`` into the global top-k ``[B, k]``."""
    vals, pos = topk_stable(scores, min(k, scores.shape[1]))
    return vals, torch.gather(indices, 1, pos)
