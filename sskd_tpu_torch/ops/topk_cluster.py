"""Clustered (cell-probe) top-k, the IVF analog (port of
sskd_tpu/ops/topk_cluster.py).

Search = centroid scoring (one small ``[B, n_cells]`` matmul), the top
``nprobe`` cells per query, then a sweep of those cells' rows only. Rows stay
int8 with scales (or f32), so in-cell scores equal the exact engines' and
recall is lost to cell pruning alone, which ``IndexBuilder.validate()`` gates.

Shapes: corpus ``[P, D]`` row-reordered so that cell ``i`` owns rows
``[i * rpc, (i + 1) * rpc)``, ``P >= n_cells * rpc`` (tail padding masked via
``valid_n``). Indices come back in REORDERED space: the caller (IndexBuilder)
maps them through its stored permutation.

The per-cell scores are the kernels of csrc/cell_gather.cu, chosen as the
JAX package chooses its two: one query goes to ``cell_gather_b1``, any other
batch to ``cell_gather``, which has three routes (:func:`cell_gather_route`):
int8 rows on the tensor cores, each probed cell read once, counted also in
``cell_gather.tc_launches``; bf16 rows, counted also in ``bf16_launches``
(both wrappers); f32 rows on CUDA cores. A bf16 corpus is scored against
the query rounded to bf16 (:func:`cell_queries`), as the JAX package's cell
paths round it (``q.astype(corpus.dtype)``): the products of two bf16 are
exact in f32 and the sums are f32. Each wrapper launches its kernel on a
CUDA tensor and counts the launch in its ``launches`` attribute; on a CPU
tensor it runs its plain torch version (``cell_gather_plain``,
``cell_gather_b1_plain``), which keeps its kernel's order of the two scale
products. The JAX package's
``clustered_topk_impl`` twin exists to avoid a nested jit; PyTorch runs
eagerly, so there is one function here.
"""

from __future__ import annotations

import torch

from sskd_tpu_torch.ops import _build
from sskd_tpu_torch.ops.topk_kernels import (
    BIN_W,
    NEG_INF,
    _check_cuda,
    _fn,
    _ptr,
    _stream,
    quantize_queries,
    topk_stable,
)

# Above this batch IndexBuilder.search and the fused searcher give a clustered
# index to the approx sweep, as the JAX package does. A TPU measured the
# threshold (the probes' union nears the whole corpus at large batches), and a
# batch of 200 once faulted a TPU worker in the general kernel; neither concerns
# the GPU kernels, which take any batch. Kept as the JAX package's behaviour.
CLUSTER_MAX_BATCH = 64

_MODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
_MAX_ROW_BYTES = 48 * 1024  # the kernels keep the query row in shared memory
# the longest int8 row the tensor-core route takes (csrc/cell_gather.cu
# TC_MAX_ROW_BYTES): the widths of the models the port serves, and those the
# card's tests cover; longer rows take the CUDA-core kernel
CELL_TC_MAX_ROW_BYTES = 1024


def cell_gather_route(dtype: torch.dtype, row_bytes: int) -> str:
    """The kernel a CUDA call of :func:`cell_gather` launches: ``"tc"``
    (``cell_gather_tc_kernel``: each probed cell's rows brought into shared
    memory once and scored against all its queries by int8 mma) for int8
    rows of at most ``CELL_TC_MAX_ROW_BYTES``; ``"bf16"``
    (``cell_gather_kernel`` in its bf16 mode) for bf16; ``"cuda_core"``
    (``cell_gather_kernel``, a block per (query, slot, tile)) for f32 and
    longer int8 rows."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "tc" if dtype == torch.int8 and row_bytes <= CELL_TC_MAX_ROW_BYTES else "cuda_core"


def cell_queries(queries: torch.Tensor, corpus: torch.Tensor):
    """The cell kernels' query operand: the queries in the corpus type (bf16
    rounded to nearest even for a bf16 corpus, f32 for f32), or int8 queries
    and their f32 scales [B] for an int8 corpus."""
    if corpus.dtype == torch.bfloat16:
        return queries.to(torch.bfloat16).contiguous(), None
    return quantize_queries(queries, corpus)


def _check_cells(q_in, q_scale, corpus, row_scales, probe, rows_per_cell, one_query):
    """Validate what both cell-gather kernels read; returns (mode, row_bytes)."""
    if corpus.dtype not in _MODES:
        raise TypeError(f"corpus dtype {corpus.dtype} not in float32 / bfloat16 / int8")
    mode = _MODES[corpus.dtype]
    if q_in.dim() != 2 or corpus.dim() != 2 or probe.dim() != 2:
        raise ValueError("queries, corpus and probe must be 2-D")
    if q_in.dtype != corpus.dtype:
        raise TypeError(f"queries must be {corpus.dtype}, as the corpus")
    B = q_in.shape[0]
    if q_in.shape[1] != corpus.shape[1]:
        raise ValueError(f"query dim {q_in.shape[1]} != corpus columns {corpus.shape[1]}")
    if one_query and B != 1:
        raise ValueError(f"cell_gather_b1 takes one query, got {B}")
    if B < 1 or probe.shape[0] != B or probe.shape[1] < 1 or probe.dtype != torch.int32:
        raise ValueError("probe must be int32 [B, nprobe] with nprobe >= 1")
    if rows_per_cell < 1 or corpus.shape[0] < rows_per_cell:
        raise ValueError(f"rows_per_cell {rows_per_cell} outside [1, {corpus.shape[0]}]")
    if mode == 1 and row_scales is None:
        raise ValueError("an int8 corpus requires row_scales")
    if row_scales is not None and (
        row_scales.dtype != torch.float32 or row_scales.shape != (corpus.shape[0],)
    ):
        raise ValueError("row_scales must be float32 [P]")
    if mode == 1 and (
        q_scale is None or q_scale.dtype != torch.float32 or q_scale.shape != (B,)
    ):
        raise ValueError("an int8 corpus needs q_scale float32 [B]")
    return mode, corpus.shape[1] * corpus.element_size()


def _check_cells_cuda(name, row_bytes, corpus, probe, rows_per_cell, check_probe, *tensors):
    if corpus.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {corpus.device}")
    if row_bytes % 16 or row_bytes > _MAX_ROW_BYTES:
        raise ValueError(
            f"{name} needs corpus rows of a multiple of 16 bytes, at most {_MAX_ROW_BYTES}"
        )
    _check_cuda(corpus, probe, *tensors)
    if check_probe:
        lo, hi = (int(v) for v in torch.stack(torch.aminmax(probe)).tolist())
        n_cells = corpus.shape[0] // rows_per_cell
        if lo < 0 or hi >= n_cells:
            raise ValueError(f"probe holds cells in [{lo}, {hi}], outside [0, {n_cells})")


def cell_gather(q_in, q_scale, corpus, row_scales, probe, rows_per_cell: int,
                check_probe: bool = True) -> torch.Tensor:
    """Scores ``[B, nprobe, rpc]`` f32 of the rows of the cells ``probe [B,
    nprobe]`` (int32, each in ``[0, P // rpc)``): ``(dot * q_scale[b]) *
    row_scale`` for an int8 corpus (``q_in`` int8, quantized by the caller),
    ``dot * row_scale`` (scale optional, ``q_scale`` ignored) for f32 and
    bf16 (``q_in`` in the corpus type: :func:`cell_queries`). No row
    is masked. ``check_probe=False`` skips the range check of ``probe``, which
    waits for the device; for a probe that is in range by construction."""
    mode, row_bytes = _check_cells(q_in, q_scale, corpus, row_scales, probe, rows_per_cell, False)
    if corpus.device.type == "cpu":
        return cell_gather_plain(q_in, q_scale, corpus, row_scales, probe, rows_per_cell)
    q_scale = q_scale if mode == 1 else None
    _check_cells_cuda("cell_gather", row_bytes, corpus, probe, rows_per_cell, check_probe,
                      q_in, q_scale, row_scales)
    B, nprobe = probe.shape
    out = torch.empty((B, nprobe, rows_per_cell), dtype=torch.float32, device=corpus.device)
    # the (query, slot) pairs sorted by cell: the cells in order and the pairs' order
    cells, order = torch.sort(probe.view(-1), stable=True)
    route = cell_gather_route(corpus.dtype, row_bytes)
    if route == "tc":
        _build.check(
            _fn("cell_gather", "sskd_cell_gather_tc")(
                _ptr(q_in), _ptr(q_scale), _ptr(corpus), _ptr(row_scales), _ptr(cells),
                _ptr(order), _ptr(out), B, nprobe, rows_per_cell, row_bytes,
                _stream(corpus.device),
            ),
            "cell_gather (tensor cores)",
        )
        cell_gather.launches += 1
        cell_gather.tc_launches += 1
        return out
    _build.check(
        _fn("cell_gather", "sskd_cell_gather")(
            mode, _ptr(q_in), _ptr(q_scale), _ptr(corpus), _ptr(row_scales), _ptr(probe),
            _ptr(order), _ptr(out), B, nprobe, rows_per_cell, row_bytes,
            _stream(corpus.device),
        ),
        "cell_gather",
    )
    cell_gather.launches += 1
    cell_gather.bf16_launches += route == "bf16"
    return out


cell_gather.launches = 0
cell_gather.tc_launches = 0  # the launches that took the tensor-core route
cell_gather.bf16_launches = 0  # the launches that took the bf16 route


def cell_gather_b1(q_in, q_scale, corpus, row_scales, probe, rows_per_cell: int,
                   check_probe: bool = True) -> torch.Tensor:
    """:func:`cell_gather` for one query, ``[1, nprobe, rpc]``: the kernel
    computes ``dot * row_scale`` and the query's scale is multiplied in
    afterwards, here, as the JAX package's one-query kernel leaves it to its
    caller."""
    mode, row_bytes = _check_cells(q_in, q_scale, corpus, row_scales, probe, rows_per_cell, True)
    if corpus.device.type == "cpu":
        return cell_gather_b1_plain(q_in, q_scale, corpus, row_scales, probe, rows_per_cell)
    q_scale = q_scale if mode == 1 else None
    _check_cells_cuda("cell_gather_b1", row_bytes, corpus, probe, rows_per_cell, check_probe,
                      q_in, q_scale, row_scales)
    nprobe = probe.shape[1]
    out = torch.empty((1, nprobe, rows_per_cell), dtype=torch.float32, device=corpus.device)
    _build.check(
        _fn("cell_gather", "sskd_cell_gather_b1")(
            mode, _ptr(q_in), _ptr(corpus), _ptr(row_scales), _ptr(probe), _ptr(out),
            nprobe, rows_per_cell, row_bytes, _stream(corpus.device),
        ),
        "cell_gather_b1",
    )
    cell_gather_b1.launches += 1
    cell_gather_b1.bf16_launches += corpus.dtype == torch.bfloat16
    return out * q_scale[0] if q_scale is not None else out


cell_gather_b1.launches = 0
cell_gather_b1.bf16_launches = 0  # the launches over bf16 rows


def _cell_dots(q_row, corpus, cells, rows_per_cell):
    """``(dots [nprobe * rpc] f32, rows [nprobe * rpc] int64)`` of one query
    against the rows of ``cells``; int8 values < 2^24 stay exact in f32, and
    so does each product of two bf16."""
    lane = torch.arange(rows_per_cell, device=corpus.device)
    rows = (cells.to(torch.int64)[:, None] * rows_per_cell + lane).reshape(-1)
    return corpus[rows].to(torch.float32) @ q_row.to(torch.float32), rows


def cell_gather_plain(q_in, q_scale, corpus, row_scales, probe, rows_per_cell: int):
    """Plain torch version of :func:`cell_gather`, one query at a time."""
    B, nprobe = probe.shape
    out = []
    for b in range(B):
        s, rows = _cell_dots(q_in[b], corpus, probe[b], rows_per_cell)
        if corpus.dtype == torch.int8:
            s = (s * q_scale[b]) * row_scales[rows]
        elif row_scales is not None:
            s = s * row_scales[rows]
        out.append(s.view(nprobe, rows_per_cell))
    return torch.stack(out)


def cell_gather_b1_plain(q_in, q_scale, corpus, row_scales, probe, rows_per_cell: int):
    """Plain torch version of :func:`cell_gather_b1`: ``(dot * row_scale) *
    q_scale``."""
    s, rows = _cell_dots(q_in[0], corpus, probe[0], rows_per_cell)
    if row_scales is not None:
        s = s * row_scales[rows]
    if corpus.dtype == torch.int8:
        s = s * q_scale[0]
    return s.view(1, probe.shape[1], rows_per_cell)


def flat_topk(scores: torch.Tensor, k: int):
    """Exact top-k over wide rows ``[B, n]``, the lower position on a tie
    (the contract of the JAX package's ``_flat_topk``). Two levels where that
    is less work: maxima of 128-wide bins, the top-k bins, a sort of those
    bins' entries alone. The chosen bins are taken in order of position, so
    the stable sort breaks ties as a sort of the whole row would, and a slot
    of no live bin is masked, never returned."""
    B, n = scores.shape
    kb = min(k, n // BIN_W)
    if n % BIN_W or (kb + 1) * BIN_W >= n:
        return topk_stable(scores, k)
    binned = scores.view(B, n // BIN_W, BIN_W)
    bin_vals, bins = topk_stable(binned.amax(dim=2), kb)  # [B, kb]
    bins, order = torch.sort(bins, dim=1)
    bin_vals = torch.gather(bin_vals, 1, order)
    cand = torch.gather(binned, 1, bins[:, :, None].expand(B, kb, BIN_W))
    cand = torch.where(bin_vals[:, :, None] > NEG_INF / 2, cand, NEG_INF)
    vals, pos = topk_stable(cand.reshape(B, kb * BIN_W), k)
    idx = torch.gather(bins, 1, pos // BIN_W) * BIN_W + pos % BIN_W
    return vals, idx


def clustered_topk(
    queries: torch.Tensor,  # [B, D] f32 (L2-normalized by the caller)
    corpus: torch.Tensor,  # [P, D] f32 / bf16 / int8, cell-contiguous rows
    centroids: torch.Tensor,  # [n_cells, D] f32, L2-normalized
    k: int,
    nprobe: int,
    rows_per_cell: int,
    row_scales: torch.Tensor | None = None,  # [P] f32 when corpus is int8
    valid_n: int | None = None,
    index_offset: int = 0,
    kernels: bool = True,
):
    """``(scores [B, k] f32, indices [B, k] int32 in reordered space)`` with
    ``(-inf, -1)`` sentinels ("-inf" is ``finfo(float32).min / 2``).
    ``nprobe`` is clipped to the number of cells; rows whose position is
    ``>= valid_n`` are never returned; ``k`` beyond ``nprobe * rpc`` is
    padded. ``index_offset`` shifts positions before the mask and in the
    result (global positions of a shard's rows). ``kernels=False`` scores
    the cells with the plain versions wherever the tensors lie (what a run on
    the card holds the kernels against); the default goes through the wrappers."""
    B = queries.shape[0]
    n_cells = centroids.shape[0]
    rpc = int(rows_per_cell)
    nprobe = min(int(nprobe), n_cells)
    valid_n = corpus.shape[0] if valid_n is None else int(valid_n)

    q = queries.to(torch.float32)
    # probe: score the centroids, keep the top nprobe cells (the lower on a tie)
    _, probe = topk_stable(q @ centroids.T, nprobe)
    probe = probe.to(torch.int32).contiguous()

    q_in, q_scale = cell_queries(q, corpus)
    if kernels:
        gather = cell_gather_b1 if B == 1 else cell_gather
        # the probe is a top-k over n_cells columns: in range by construction
        scores = gather(q_in, q_scale, corpus, row_scales, probe, rpc, check_probe=False)
    else:
        gather = cell_gather_b1_plain if B == 1 else cell_gather_plain
        scores = gather(q_in, q_scale, corpus, row_scales, probe, rpc)
    scores = scores.reshape(B, nprobe * rpc)

    # mask the tail padding, extract the global top-k
    lane = torch.arange(rpc, device=corpus.device, dtype=torch.int32)
    gidx = (probe[:, :, None] * rpc + lane).reshape(B, nprobe * rpc) + int(index_offset)
    scores = torch.where(gidx < valid_n, scores, NEG_INF)

    k_eff = min(k, nprobe * rpc)
    vals, pos = flat_topk(scores, k_eff)
    idx = torch.gather(gidx, 1, pos)
    idx = torch.where(vals > NEG_INF / 2, idx, -1)
    if k_eff < k:
        vals = torch.cat([vals, vals.new_full((B, k - k_eff), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, k - k_eff), -1)], dim=1)
    return vals, idx
