"""Encode and search in one device pass per (micro-)batch (port of
sskd_tpu/serve/fused.py, ``FusedSearcher``).

Tokenization runs on the host; the query encode and the top-k run back to
back on the device with no copy between them, and the host waits once, for
the ``[B, k]`` result. PyTorch runs eagerly, so there is no program to
compile per shape: ``warmup`` builds the kernels and touches each batch
bucket, so that the first request pays neither. The index is an exact, approx
or clustered one that :meth:`IndexBuilder.check_searchable` admits.

A clustered index is served through the approx sweep over its reordered rows
unless the environment has ``SSKD_SERVE_CELL_PROBE=1`` and the padded batch is
at most ``CLUSTER_MAX_BATCH``: the JAX package's switch and its default, which
a TPU measured. Results are mapped back to original row positions either way.
Any other index with bf16 refine rows is served by the refined engine, exact
ones too (as the JAX package serves them, while its ``IndexBuilder.search``
refines only an approx index): ``"refined"`` with the rows on the device, or
``"host_refined"``, where the device pass ends at the candidates and the
rescore runs on the host (``refine_storage="host"``).

:class:`ShardedFusedSearcher` serves an index sharded over a mesh
(``mesh.index_parallel > 1``): the same encode, then the sharded index's
per-shard search and merge. Over an index whose shards span the processes
of a group, every rank encodes the same texts and gets the same ids, as the
JAX package's fused program does on a global mesh.
"""

from __future__ import annotations

import os

import torch

from sskd_tpu_torch.models.student import bucket_length, buckets_for
from sskd_tpu_torch.ops.topk import cosine_topk, refined_candidates, refined_topk
from sskd_tpu_torch.ops.topk_cluster import CLUSTER_MAX_BATCH, clustered_topk
from sskd_tpu_torch.parallel.mesh import same_device

K_BUCKETS = (10, 20, 50, 100, 200, 400)


class FusedSearcher:
    """Tokenize on the host; encode + top-k on the device."""

    def __init__(self, student, builder):
        if builder.device != student.device:
            raise ValueError(
                f"student on {student.device} but index on {builder.device}"
            )
        builder.check_searchable()
        builder.ensure_device()
        self.student = student
        self.builder = builder

    @property
    def ntotal(self) -> int:
        return self.builder.ntotal

    def _engine(self, padded_n: int) -> str:
        """The device engine for a padded batch size: ``refined`` or
        ``host_refined`` for a non-clustered index with refine rows (by its
        ``refine_storage``: a served quantized index keeps the recall its
        rescore was built for), else the index's own type, except that a
        clustered index is swept as ``approx`` unless cell probing is opted
        into and the batch is small enough for it."""
        if self.builder.index_type != "clustered":
            if self.builder._refine is not None:
                return "host_refined" if self.builder.refine_storage == "host" else "refined"
            return self.builder.index_type
        if (
            os.environ.get("SSKD_SERVE_CELL_PROBE", "0") == "1"
            and padded_n <= CLUSTER_MAX_BATCH
        ):
            return "clustered"
        return "approx"

    def bucket_k(self, k: int) -> int:
        for bucket in K_BUCKETS:
            if k <= bucket <= max(self.ntotal, K_BUCKETS[0]):
                return bucket
        return k

    def _topk(self, q: torch.Tensor, k: int, engine: str):
        """The device engine's ``(vals, idx)`` for the encoded queries, or
        the candidates alone for ``host_refined``."""
        b = self.builder
        if engine == "clustered":
            return clustered_topk(
                q,
                b.device_vectors,
                b.device_centroids,
                k=k,
                nprobe=b.nprobe,
                rows_per_cell=b._rows_per_cell,
                row_scales=b.device_scales,
                valid_n=b.ntotal,
            )
        if engine == "refined":
            return refined_topk(
                q, b.device_vectors, b.device_refine, k, refine_m=b.refine_m,
                row_scales=b.device_scales, valid_n=b.ntotal,
            )
        if engine == "host_refined":
            # the device pass ends at the candidates; the query embeddings
            # and the candidates go to the host for the rescore
            return refined_candidates(
                q, b.device_vectors, max(b.refine_m, k),
                row_scales=b.device_scales, valid_n=b.ntotal,
            )[1]
        return cosine_topk(
            q,
            b.device_vectors,
            k=k,
            block_rows=b.block_rows,
            row_scales=b.device_scales,
            valid_n=b.ntotal,
            method=engine,
            recall_target=b.recall_target,
        )

    def _map_positions(self, idx):
        return self.builder.map_positions(idx)

    def search_texts(self, queries: list[str], k: int):
        """Returns (scores [B, k], indices [B, k]) numpy."""
        k_eff = min(self.bucket_k(k), self.ntotal)
        n = len(queries)
        padded_n = bucket_length(n, 256, self.student.device)
        texts = [self.student.query_prefix + t for t in queries] + [
            self.student.query_prefix
        ] * (padded_n - n)
        batch = self.student.tokenize_batch(texts)
        engine = self._engine(padded_n)
        with torch.inference_mode():
            q = self.student.forward_batch(batch)
            out = self._topk(q, k_eff, engine)
        if engine == "host_refined":
            vals, idx = self.builder._host_rescore(q.float().cpu().numpy(), out.cpu().numpy(),
                                                   k_eff)
        else:
            vals, idx = out[0].cpu().numpy(), out[1].cpu().numpy()
        return vals[:n, :k], self._map_positions(idx)[:n, :k]

    def warmup(self, max_batch: int = 64, k: int = 10) -> None:
        for bucket in buckets_for(self.student.device):
            if bucket > max_batch:
                break
            self.search_texts(["warmup"] * bucket, k)
        self.search_texts(["warmup"], k)


class ShardedFusedSearcher(FusedSearcher):
    """The fused searcher over a :class:`~sskd_tpu_torch.index.sharded.
    ShardedIndex` (port of ``sskd_tpu/serve/fused.py`` ``ShardedFusedSearcher``):
    the queries are encoded on the index's ``query_device`` (the first
    device of the shards this process holds), where the student lives, and
    swept by the index's ``shard_search``. Across processes every rank calls
    :meth:`search_texts` with the same texts."""

    def __init__(self, student, sharded):
        if not same_device(student.device, sharded.query_device):
            raise ValueError(
                f"student on {student.device} but the index takes its queries on "
                f"{sharded.query_device}"
            )
        self.student = student
        self.builder = None
        self.sharded = sharded

    @property
    def ntotal(self) -> int:
        return self.sharded.ntotal

    def _engine(self, padded_n: int) -> str:
        return "sharded"

    def _topk(self, q: torch.Tensor, k: int, engine: str):
        return self.sharded.shard_search(k)(q, *self.sharded.index_args())

    def _map_positions(self, idx):
        return self.sharded.map_positions(idx)
