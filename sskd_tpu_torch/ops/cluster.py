"""Balanced clustering for the IVF-style "clustered" index mode (the port's
own copy of sskd_tpu/ops/cluster.py: numpy only, same arithmetic and the same
draws from ``default_rng(seed)`` in the same order, so the same embeddings
give the same permutation and centroids as the JAX package, bit for bit).

The mode is a *pruned sweep*, not a quantized inverted list: partition the
corpus rows into equal-size, spatially coherent cells; at query time score
the cell centroids (one small matmul), pick ``nprobe`` cells per query, and
sweep only those rows. Operations and memory traffic drop by about ``nprobe /
n_cells`` while every other engine contract is unchanged.

Why *balanced* partitions instead of plain k-means: equal cells make the
probe sweep a fixed ``[B, nprobe, rows_per_cell]`` computation — no ragged
inverted lists, no host-side gather — and the layout on disk is the one the
JAX package reads. The builder reorders rows once (a permutation, stored
alongside the index) so each cell is one contiguous block of device memory.

The partitioner is a quota-balanced recursive bisection: at each node,
estimate the dominant separation direction with a 2-means step, then
`argpartition` the node's rows along it at the exact row quota of the
left subtree (rank order inside each half is refined by deeper levels).
Leaves get exactly ``rows_per_cell`` rows (the final leaf takes the
remainder; the global tail is padded and masked by ``valid_n``).
"""

from __future__ import annotations

import numpy as np

from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("ops.cluster")

# Cell sizes are rounded to this multiple. The reason was the TPU compiler's
# (a cell had to be a legal block of 32-row int8 tiles); the GPU kernels take
# any cell size. It stays because it decides rows_per_cell, and with it the
# on-disk layout that both packages must build alike.
CELL_ROW_MULTIPLE = 256


def auto_cells(n_rows: int, target_rows_per_cell: int = 0) -> tuple[int, int]:
    """Pick (n_cells, rows_per_cell). Default heuristic: cells of about
    sqrt(N) rows (the classic IVF nlist ~ sqrt(N) balance between centroid
    scan cost and per-cell sweep cost), rounded to CELL_ROW_MULTIPLE."""
    if target_rows_per_cell <= 0:
        target_rows_per_cell = int(np.sqrt(max(n_rows, 1)))
    rpc = max(
        CELL_ROW_MULTIPLE,
        -(-target_rows_per_cell // CELL_ROW_MULTIPLE) * CELL_ROW_MULTIPLE,
    )
    n_cells = max(1, -(-n_rows // rpc))
    return n_cells, rpc


# direction estimation runs on a bounded subsample: the split only needs a
# statistically stable separation axis (the PARTITION over all rows still
# uses every row), and full-node means and gathers dominate large builds
_DIRECTION_SAMPLE = 65536


def _split_direction(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One 2-means-style step: the direction between the means of a random
    halving, refined once by the induced partition. Cheap and good enough
    for a *median* split (only the ordering matters, not the boundary)."""
    n = x.shape[0]
    idx = rng.permutation(n)
    c1 = x[idx[: n // 2]].mean(axis=0)
    c2 = x[idx[n // 2 :]].mean(axis=0)
    d = c1 - c2
    norm = np.linalg.norm(d)
    if norm < 1e-9:
        d = rng.standard_normal(x.shape[1]).astype(x.dtype)
        norm = np.linalg.norm(d)
    d = d / norm
    # refine: re-estimate from the sign partition of the first projection
    proj = x @ d
    med = np.median(proj)
    left, right = proj <= med, proj > med
    if left.any() and right.any():
        d2 = x[left].mean(axis=0) - x[right].mean(axis=0)
        n2 = np.linalg.norm(d2)
        if n2 > 1e-9:
            d = d2 / n2
    return d


def build_clusters(
    embeddings: np.ndarray,
    n_cells: int,
    rows_per_cell: int,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Partition ``embeddings`` [N, D] into ``n_cells`` contiguous cells of
    exactly ``rows_per_cell`` rows (the last cell takes the remainder).

    Returns:
      perm: int32 [N] — reordered position p holds original row perm[p];
        cell i owns reordered rows [i*rows_per_cell, (i+1)*rows_per_cell).
      centroids: f32 [n_cells, D] — L2-normalized cell means (so centroid
        scoring is the same cosine the row sweep uses).
    """
    # Permutation-only scheme: x is never copied or reordered, only the
    # int64 `perm` array moves, because every materialized gather or copy of
    # a large corpus is slow on the host. Per node, the split direction comes
    # from a bounded subsample and the full-node projection is computed by
    # chunked gathers into one small preallocated buffer; `argpartition`
    # (O(R), exact at the quota; rank order inside each half is refined by
    # deeper levels) then reorders only `perm`.
    x = np.ascontiguousarray(embeddings, dtype=np.float32)
    n, dim = x.shape
    if n_cells * rows_per_cell < n:
        raise ValueError("n_cells * rows_per_cell must cover all rows")
    rng = np.random.default_rng(seed)

    # quotas: every cell exactly rows_per_cell, last cell takes the tail
    quotas = [rows_per_cell] * (n_cells - 1)
    quotas.append(n - rows_per_cell * (n_cells - 1))
    if quotas[-1] <= 0:  # tiny corpora: fewer effective cells
        quotas = []
        left = n
        while left > 0:
            take = min(rows_per_cell, left)
            quotas.append(take)
            left -= take
        quotas += [0] * (n_cells - len(quotas))
    qprefix = np.concatenate([[0], np.cumsum(quotas)])  # row offset of cell i

    perm = np.arange(n, dtype=np.int64)
    chunk = _DIRECTION_SAMPLE
    rowbuf = np.empty((min(chunk, n), dim), np.float32)  # reused gather target
    projbuf = np.empty(n, np.float32)  # per-level projections (nodes disjoint)

    def _node_proj(seg_idx: np.ndarray, d: np.ndarray, lo: int) -> None:
        for off in range(0, len(seg_idx), chunk):
            m = min(chunk, len(seg_idx) - off)
            np.take(x, seg_idx[off : off + m], axis=0, out=rowbuf[:m])
            np.dot(rowbuf[:m], d, out=projbuf[lo + off : lo + off + m])

    # level-synchronous worklist of (row_lo, row_hi, cell_lo, cell_hi)
    nodes: list[tuple[int, int, int, int]] = [(0, n, 0, n_cells)]
    while nodes:
        nxt: list[tuple[int, int, int, int]] = []
        for lo, hi, clo, chi in nodes:
            if chi - clo <= 1 or hi - lo == 0:
                continue
            mid = clo + (chi - clo) // 2
            left_quota = int(qprefix[mid] - qprefix[clo])
            if 0 < left_quota < hi - lo:
                seg_idx = perm[lo:hi]
                n_seg = hi - lo
                # with-replacement integer sampling: statistically
                # equivalent for a mean-direction estimate and O(sample)
                # instead of O(node) (choice(replace=False) permutes the
                # whole node)
                m = min(n_seg, _DIRECTION_SAMPLE)
                sub = seg_idx if n_seg <= m else seg_idx[rng.integers(0, n_seg, m)]
                np.take(x, sub, axis=0, out=rowbuf[:m])
                d = _split_direction(rowbuf[:m], rng)
                _node_proj(seg_idx, d, lo)
                order = np.argpartition(projbuf[lo:hi], left_quota - 1)
                perm[lo:hi] = seg_idx[order]
            # degenerate quota (empty trailing cells): split positionally
            nxt.append((lo, lo + left_quota, clo, mid))
            nxt.append((lo + left_quota, hi, mid, chi))
        nodes = nxt

    centroids = np.zeros((n_cells, dim), np.float32)
    for i, q in enumerate(quotas):
        if q > 0:
            pos = int(qprefix[i])
            for off in range(0, q, chunk):
                m = min(chunk, q - off)
                np.take(x, perm[pos + off : pos + off + m], axis=0, out=rowbuf[:m])
                centroids[i] += rowbuf[:m].sum(axis=0)
            centroids[i] /= q
    norms = np.linalg.norm(centroids, axis=1, keepdims=True)
    centroids = centroids / np.maximum(norms, 1e-12)
    logger.info(
        f"clustered {n} rows into {n_cells} cells x {rows_per_cell} "
        f"(tail {quotas[-1]})"
    )
    return perm.astype(np.int32), centroids
