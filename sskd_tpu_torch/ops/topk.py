"""Cosine/dot top-k over a device-resident corpus (port of
sskd_tpu/ops/topk.py, its exact, approx and refined engines).

Three engines, one contract: ``(scores [B, k] f32, indices [B, k] int32)``,
missing results ``(finfo(f32).min / 2, -1)``, rows ``>= valid_n`` never
returned, ties broken toward the lower row. ``index_offset`` (a shard's
first global row, :mod:`sskd_tpu_torch.index.sharded`) is added to the
returned positions, and ``valid_n`` counts global rows: a row is live where
its position plus the offset is below it.

- The two-phase kernel engine (:mod:`sskd_tpu_torch.ops.topk_kernels`),
  taken on CUDA when :func:`kernel_exact_ok` holds.
- The blocked plain engine (:func:`cosine_topk_core`): ``torch.matmul`` per
  block of rows, ``torch.topk`` per block, one merge. It serves the CPU and
  the shapes the gate turns away, as the JAX package leaves those to XLA.
- The approx engine (:func:`approx_topk`, ``method="approx"``), which stands
  in for ``lax.approx_max_k``: that operation folds a query's scores into L
  bins, keeps each bin's maximum and its position, and takes an exact top-k
  over the bins, losing a result only where two of the top k share a bin.
  Here one pass over the corpus (``binmax_strided``) gives the maximum and
  its row for bins whose rows lie far apart, so that near neighbours stored
  side by side do not share one; the bins are folded to the number the
  recall target asks for, a top-k over them is the answer, and neither
  ``bin_gather`` nor a second pass runs. XLA sizes L from the recall target,
  at least about ``(k - 1) / -ln(recall_target)`` bins, and does not reduce
  a row shorter than that. Here a corpus of fewer 128-row tiles than that
  number of bins (or ``recall_target`` 1.0) goes to the exact engine: the
  reduction would save it no pass worth the lost results.
- The refined engine (:func:`refined_topk`): a quantized sweep fetches
  ``refine_m`` candidates (:func:`refined_candidates`), whose bf16 rows are
  rescored against the query (:func:`rescore_candidates`). As in the JAX
  package the rescore is plain tensor code (XLA there, torch ops here), not
  a kernel.

Corpora: f32, bf16 (an f32 query against the widened rows, the TPU kernels'
bf16 branch), int8 and packed int4 rows. On a CUDA corpus of any other type
the engines raise (:func:`kernel_exact_ok`): no kernel takes it, and none
of them falls back to its plain version for it.
"""

from __future__ import annotations

import math

import torch

from sskd_tpu_torch.ops.quant import quantize_rows, unpack_int4
from sskd_tpu_torch.ops.topk_kernels import (
    BIN_W,
    K_MAX,
    NEG_INF,
    binmax_strided,
    binmax_strided_plain,
    cosine_topk_kernels,
    quantize_queries,
    topk_stable,
)


def cosine_topk_core(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    block_rows: int = 262144,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    index_offset: int = 0,
    method: str = "exact",
    recall_target: float = 0.99,
):
    """The plain engines. ``exact``: blocked matmul and top-k. ``corpus``
    [N, D] f32, bf16 (widened to f32 a block at a time, against the f32
    query) or int8, or [N, D/2] uint8 packed int4 (unpacked here, as the JAX
    package does off the kernel path). For int8 / int4 the queries are
    quantized per row and the integer dot is taken exactly, then ``* q_scale
    * row_scale``. ``approx``: :func:`approx_topk` over ``binmax_strided_plain``."""
    if method == "approx":
        return approx_topk(
            queries, corpus, k, row_scales=row_scales, valid_n=valid_n,
            index_offset=index_offset, recall_target=recall_target, kernels=False,
        )
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    off = int(index_offset)
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
        if hi + off > valid_n:
            rows = torch.arange(lo + off, hi + off, device=corpus.device)
            scores = torch.where(rows[None, :] < valid_n, scores, NEG_INF)
        v, pos = topk_stable(scores, min(k_eff, hi - lo))
        parts_v.append(v)
        parts_i.append(pos + (lo + off))
    vals, pos = topk_stable(torch.cat(parts_v, dim=1), k_eff)
    idx = torch.gather(torch.cat(parts_i, dim=1), 1, pos).to(torch.int32)
    if k_eff < k:  # pad out to the requested k
        vals = torch.cat([vals, vals.new_full((B, k - k_eff), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, k - k_eff), -1)], dim=1)
    idx = torch.where(vals > NEG_INF / 2, idx, -1)
    return vals, idx


def local_valid(n: int, valid_n: int | None, index_offset: int) -> int:
    """Rows of an ``n``-row corpus whose global position (position plus
    ``index_offset``) is below ``valid_n``: the count the kernels mask by."""
    valid_n = n if valid_n is None else int(valid_n)
    return max(0, min(n, valid_n - int(index_offset)))


def offset_positions(idx: torch.Tensor, index_offset: int) -> torch.Tensor:
    """Local positions to global ones; the -1 of a missing result stays."""
    if not index_offset:
        return idx
    return torch.where(idx >= 0, idx + int(index_offset), -1).to(torch.int32)


# the corpus types the top-k kernels take (csrc/binmax.cu, csrc/bin_gather.cu)
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.uint8)


def on_card(corpus: torch.Tensor) -> bool:
    """Whether the engines take the kernels for ``corpus``: True on a CUDA
    device for the types of ``KERNEL_DTYPES``, False on the CPU; a CUDA
    corpus of another type raises, since it would otherwise reach the plain
    versions unseen."""
    if corpus.device.type != "cuda":
        return False
    if corpus.dtype not in KERNEL_DTYPES:
        raise TypeError(f"no kernel takes {corpus.dtype} rows on {corpus.device}")
    return True


def kernel_exact_ok(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> bool:
    """Gate of the two-phase kernel engine: a corpus :func:`on_card` (which
    raises for a CUDA corpus of a type no kernel takes), k within the
    kernels' capacity, and a corpus of more than 2 * k bins' rows (below that
    the rescan is no cheaper than a full sweep, and the engines take the
    blocked matmul, as the JAX package leaves those shapes to XLA). Shapes
    the kernels cannot take past this gate make their wrappers raise."""
    return on_card(corpus) and 1 <= k <= K_MAX and corpus.shape[0] > 2 * k * BIN_W


# Blocks of the strided pass: four for each of the H100's 132 SMs up to 64
# queries, half as many above, where each block runs once per 64 queries
# (csrc/binmax.cu ST_QUERIES) and its output (blocks * 128 * B * 8 bytes before
# the fold) grows with the batch. chip_smoke.py times the tensor-core pass at
# 133 to 2,100 blocks for B in {1, 16, 64, 256}.
APPROX_BLOCKS = 528
APPROX_CHUNK = 64


def approx_blocks(batch: int, groups: int, n_tiles: int) -> int:
    """Blocks of the strided pass: a multiple of ``groups`` under the cap."""
    cap = APPROX_BLOCKS if batch <= APPROX_CHUNK else APPROX_BLOCKS // 2
    return groups * max(1, min(cap, n_tiles) // groups)


def approx_min_bins(k: int, recall_target: float) -> float:
    """Fewest bins at which the approx engine reduces: with L bins the chance
    that a given one of the top k shares its bin with another is about
    ``(k - 1) / L``, so the expected recall is about ``exp(-(k - 1) / L)``."""
    if recall_target >= 1.0:
        return math.inf
    return (k - 1) / -math.log(recall_target)


def approx_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    recall_target: float = 0.99,
    kernels: bool | None = None,
    index_offset: int = 0,
):
    """Approximate top-k in one pass. The bins the answer is taken from are
    ``groups * 128`` in number, ``groups`` the fewest that give
    :func:`approx_min_bins` bins: bin ``(g, t)`` holds the rows ``(g + i *
    groups) * 128 + t``. The pass itself runs ``groups * fold`` blocks, to
    fill the card, and its bins are folded ``fold`` to one afterwards. A
    corpus of fewer 128-row tiles than :func:`approx_min_bins` is answered
    by the exact engine.

    ``kernels``: True runs the ``binmax_strided`` kernel (and, below the
    threshold, the exact kernel engine where :func:`kernel_exact_ok` holds),
    False the plain versions; None (the default) takes the kernels for a
    corpus :func:`on_card`. The plain pass scores a chunk of rows at a time,
    so no f32 copy of a quantized corpus is ever held. The pass runs over
    local positions (``index_offset`` folded into the valid count), and the
    offset is added to what it returns."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target {recall_target} outside (0, 1]")
    if kernels is None:
        kernels = on_card(corpus)
    if corpus.dtype in (torch.int8, torch.uint8) and row_scales is None:
        raise ValueError("an int8 or int4 corpus requires row_scales")
    B = queries.shape[0]
    n = corpus.shape[0]
    valid_n = local_valid(n, valid_n, index_offset)
    k_eff = max(1, min(k, n))
    n_tiles = (n + BIN_W - 1) // BIN_W
    need = max(k_eff, approx_min_bins(k_eff, recall_target))
    if n_tiles < need:  # also recall_target 1.0
        if kernels and kernel_exact_ok(queries, corpus, k):
            vals, idx = cosine_topk_kernels(queries, corpus, k, row_scales=row_scales,
                                            valid_n=valid_n)
        else:
            vals, idx = cosine_topk_core(queries, corpus, k, row_scales=row_scales,
                                         valid_n=valid_n)
        return vals, offset_positions(idx, index_offset)
    groups = math.ceil(need / BIN_W)
    blocks = approx_blocks(B, groups, n_tiles)
    fold = blocks // groups
    q_in, q_scale = quantize_queries(queries, corpus)
    bin_max, bin_row = (binmax_strided if kernels else binmax_strided_plain)(
        q_in, corpus, row_scales, valid_n, blocks
    )  # [fold * groups * 128, B] each; block j = i * groups + g folds into group g
    bin_max, part = bin_max.view(fold, groups * BIN_W, B).max(dim=0)  # the first on a tie
    bin_row = torch.gather(bin_row.view(fold, groups * BIN_W, B), 0, part[None])[0]
    vals, bins = topk_stable(bin_max.T, k_eff)  # [B, k_eff]
    idx = torch.gather(bin_row.T, 1, bins)
    live = vals > NEG_INF / 2  # a bin of no valid row holds the sentinel
    if q_scale is not None:
        vals = vals * q_scale[:, None]
    vals = torch.where(live, vals, NEG_INF)
    idx = torch.where(live, idx, -1)
    if k_eff < k:  # pad out to the requested k
        vals = torch.cat([vals, vals.new_full((B, k - k_eff), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, k - k_eff), -1)], dim=1)
    return vals, offset_positions(idx, index_offset)


def cosine_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    block_rows: int = 262144,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    method: str = "exact",
    recall_target: float = 0.99,
    index_offset: int = 0,
):
    """Top-k by ``queries @ corpus.T`` (cosine when both sides are
    L2-normalized, which the index builder guarantees). ``method``:
    ``"exact"`` or ``"approx"`` (with its ``recall_target``); see the module
    docstring for the engines. ``block_rows`` sizes the blocked plain exact
    engine only: the approx pass holds no score tile to bound."""
    if method == "approx":
        return approx_topk(
            queries, corpus, k, row_scales=row_scales, valid_n=valid_n,
            recall_target=recall_target, index_offset=index_offset,
        )
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    if kernel_exact_ok(queries, corpus, k):
        vals, idx = cosine_topk_kernels(
            queries, corpus, k, row_scales=row_scales,
            valid_n=local_valid(corpus.shape[0], valid_n, index_offset),
        )
        return vals, offset_positions(idx, index_offset)
    return cosine_topk_core(
        queries, corpus, k, block_rows=block_rows, row_scales=row_scales, valid_n=valid_n,
        index_offset=index_offset,
    )


# ---------------------------------------------------------------------------
# The refined engine (JAX sskd_tpu/ops/topk.py refined_candidates_core ..
# refined_topk): a quantized sweep for candidates, a bf16 rescore
# ---------------------------------------------------------------------------


def refined_candidates_core(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    refine_m: int,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    recall_target: float = 0.95,
    kernels: bool | None = None,
):
    """Candidate stage of the refined search: ``(vals [B, m], positions [B,
    m])`` of the quantized sweep alone, -1 past the rows there are (``m`` may
    exceed the row count). Packed int4 rows take the exact kernel engine
    where its gate holds (its exact candidates only raise recall@m, and
    unpacked rows are never materialized), as the JAX package takes its
    exact Pallas engine; every other corpus the approx engine at the loose
    ``recall_target``. ``kernels``: as :func:`approx_topk`; False runs the
    same engine over the plain versions. (The JAX package's ``block_rows``
    sizes its XLA sweep; the approx pass here holds no score tile to bound.)"""
    if corpus.dtype == torch.uint8 and kernel_exact_ok(queries, corpus, refine_m):
        exact = cosine_topk_kernels if kernels is not False else cosine_topk_core
        return exact(queries, corpus, refine_m, row_scales=row_scales, valid_n=valid_n)
    return approx_topk(queries, corpus, refine_m, row_scales=row_scales, valid_n=valid_n,
                       recall_target=recall_target, kernels=kernels)


def refined_candidates(queries, corpus, refine_m, row_scales=None, valid_n=None,
                       recall_target=0.95):
    """:func:`refined_candidates_core` through the kernels where they take the
    corpus (the entry of the host-refine paths)."""
    return refined_candidates_core(queries, corpus, refine_m, row_scales=row_scales,
                                   valid_n=valid_n, recall_target=recall_target)


def rescore_candidates(queries: torch.Tensor, refine_rows: torch.Tensor, cand: torch.Tensor,
                       k: int):
    """``(vals [B, k] f32, idx [B, k] int32)``: the candidates ``cand [B, m]``
    (-1 for none) rescored against their rows of ``refine_rows [N, D]`` (bf16,
    in the corpus's storage order), the query rounded to the rows' type
    first, each product widened to f32 and summed in f32; the top k, ties to
    the lower candidate slot (as ``lax.top_k``); (-inf, -1) past the live
    candidates. Written as an elementwise product and an f32 sum (B x m x D
    values, 1M at B = 64, m = 40), not a matrix product: a bf16 ``bmm``
    returns bf16, and an f32 one runs through TF32 under
    ``torch.set_float32_matmul_precision("high")``; either would round the
    scores."""
    safe = cand.clamp(0, refine_rows.shape[0] - 1).long()
    rows = refine_rows[safe].to(torch.float32)  # [B, m, D]
    q = queries.to(refine_rows.dtype).to(torch.float32)
    res = (rows * q[:, None, :]).sum(dim=-1)
    res = torch.where(cand >= 0, res, NEG_INF)
    B, m = cand.shape
    k_eff = min(k, m)
    vals, pos = topk_stable(res, k_eff)
    idx = torch.gather(cand, 1, pos).to(torch.int32)
    if k_eff < k:
        vals = torch.cat([vals, vals.new_full((B, k - k_eff), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, k - k_eff), -1)], dim=1)
    idx = torch.where(vals > NEG_INF / 2, idx, -1)
    return vals, idx


def refined_topk_core(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    refine_rows: torch.Tensor,
    k: int,
    refine_m: int = 40,
    row_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    recall_target: float = 0.95,
    kernels: bool | None = None,
):
    """Two-stage search: the quantized sweep fetches ``refine_m`` candidates
    (clamped to ``[k, N]``), whose bf16 rows are rescored exactly
    (:func:`rescore_candidates`). The sweep runs at a loose ``recall_target``
    (0.95): the true top k need only lie somewhere in the top ``refine_m``,
    and the rescore restores their order. ``kernels`` as
    :func:`refined_candidates_core`."""
    refine_m = max(k, min(refine_m, corpus.shape[0]))
    _, cand = refined_candidates_core(
        queries, corpus, refine_m, row_scales=row_scales, valid_n=valid_n,
        recall_target=recall_target, kernels=kernels,
    )
    return rescore_candidates(queries, refine_rows, cand, k)


def refined_topk(queries, corpus, refine_rows, k, refine_m=40, row_scales=None, valid_n=None,
                 recall_target=0.95):
    """:func:`refined_topk_core` through the kernels where they take the corpus."""
    return refined_topk_core(queries, corpus, refine_rows, k, refine_m=refine_m,
                             row_scales=row_scales, valid_n=valid_n,
                             recall_target=recall_target)


def merge_topk(scores: torch.Tensor, indices: torch.Tensor, k: int):
    """Merge candidate sets ``[B, M]`` into the global top-k ``[B, k]``."""
    vals, pos = topk_stable(scores, min(k, scores.shape[1]))
    return vals, torch.gather(indices, 1, pos)
