"""An index whose rows are sharded over the devices of a mesh axis (port of
sskd_tpu/index/sharded.py, ``ShardedIndex``).

Queries are replicated, each shard searches its own rows on its own device,
and the shards' ``[B, k]`` candidates are merged into the global top k. The
JAX package runs that as one ``shard_map`` with an ``all_gather`` over the
``index`` axis. Here a process issues each of its shards' kernels on the
shard's device's current stream under ``torch.cuda.device`` (the launches of
different devices overlap, as kernels are asynchronous), brings the
candidates to its first device and concatenates them in shard order (the
layout of ``all_gather(..., tiled=True)``). When the ``index`` axis spans
the processes of a group (a mesh over the group whose index line holds
every rank, :mod:`sskd_tpu_torch.parallel.mesh`), each rank holds only its
own shards and the ranks' candidates meet in one all-gather over the group
(:func:`~sskd_tpu_torch.parallel.distributed.all_gather_candidates`), in
rank order, which is shard order. Every rank then merges them with
:func:`~sskd_tpu_torch.ops.topk.merge_topk`, so that equal scores resolve as
they do in JAX and every rank holds the same result, as JAX's ``out_specs
(P(), P())`` gives. Every rank must call :meth:`search` (or the program of
:meth:`shard_search`) with the same queries, as JAX's SPMD program
requires; a rank that does not come fails the others after the group's
timeout.

Placement: shard ``j`` holds global rows ``[j * rows_per_shard, (j + 1) *
rows_per_shard)``, zero rows of scale 1.0 past ``ntotal``, masked by their
position. A process places, reads and quantizes only the rows of the shards
it holds (the counterpart of ``jax.make_array_from_callback``, which asks a
process only for its addressable shards). ``rows_per_shard`` is the row
count over the shards rounded up to 128, or for a clustered index whole
cells (``cells_per_shard * rows_per_cell``), each shard owning a contiguous
block of cells and their centroids (zero centroids pad the last shard).
bf16 refine rows are sharded beside the quantized rows, so each shard
rescores its own candidates.

Each shard's search, in the JAX package's order (:meth:`shard_search`):

1. the refine rescore (an int8 / int4 index with refine rows, not
   clustered): the candidates of the port's refined engine over
   ``max(k, min(refine_m, rows_per_shard))`` local rows
   (:func:`~sskd_tpu_torch.ops.topk.refined_candidates_core`), rescored
   against the shard's bf16 rows;
2. a clustered index at a batch of at most ``CLUSTER_MAX_BATCH``: the cell
   probe over the shard's cells (``nprobe`` clipped to them);
3. an exact index where :func:`~sskd_tpu_torch.ops.topk.kernel_exact_ok`
   holds: the two-phase kernel engine over the shard's valid rows;
4. otherwise :func:`~sskd_tpu_torch.ops.topk.cosine_topk` (the approx sweep
   for a clustered index), the engine that takes the kernels on the card:
   the JAX package's ``cosine_topk_core`` is XLA's device engine, this is
   the port's.

Every branch returns global positions (the shard's first row added, the -1
of a missing result kept); a shard that holds no valid row answers with
missing results without a launch.

``save`` / ``load`` use the ``sskd-sharded-1`` layout of the JAX package,
file for file: unpadded rows, ``meta.json`` with the checksums of the files,
independent of the mesh's shape, so an index either package saved loads in
the other onto any shard count. ``load`` memory-maps the files and each
rank reads its own shards' row ranges (the checksums stream every file, as
the JAX package's do). bf16 rows are read as their bits
(``index/builder.py``), without ``ml_dtypes``. An index whose shards lie in
more than one process is not saved: the JAX package's ``save`` fetches the
whole array (``np.asarray``), which JAX refuses for an array spanning
non-addressable devices, on every process; here ``save`` raises
``IndexBuildError`` there.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sskd_tpu_torch.exceptions import IndexBuildError, IndexLoadError, IndexVersionError
from sskd_tpu_torch.index.builder import _bf16_bits, _bf16_tensor, _load_bf16, _save_bf16
from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4
from sskd_tpu_torch.ops.topk import (
    cosine_topk,
    kernel_exact_ok,
    merge_topk,
    offset_positions,
    refined_candidates_core,
    rescore_candidates,
)
from sskd_tpu_torch.ops.topk_cluster import CLUSTER_MAX_BATCH, clustered_topk
from sskd_tpu_torch.ops.topk_kernels import NEG_INF, cosine_topk_kernels
from sskd_tpu_torch.parallel import distributed
from sskd_tpu_torch.parallel.mesh import on_device
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("index.sharded")

SHARDED_INDEX_VERSION = "sskd-sharded-1"


def _file_sha256(path: Path, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def _to_device(rows: np.ndarray, bf16: bool, device: torch.device) -> torch.Tensor:
    """Host rows (bf16 as their ``uint16`` bits) as a tensor on ``device``."""
    t = _bf16_tensor(rows) if bf16 else torch.from_numpy(np.ascontiguousarray(rows))
    return t.to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy (bf16 as its ``uint16`` bits)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class ShardedIndex:
    """Corpus rows sharded along ``axis`` of ``mesh``; search returns global
    doc positions with the contract of :meth:`IndexBuilder.search`."""

    def __init__(
        self,
        mesh,
        axis: str = "index",
        metric: str = "cosine",
        block_rows: int = 8192,
        method: str = "exact",
        recall_target: float = 0.99,
    ):
        if axis not in mesh.axis_names:
            raise IndexBuildError(f"mesh has no axis {axis!r}")
        self.mesh = mesh
        self.axis = axis
        me = distributed.rank() if mesh.ranks is not None else 0
        # shard j lives on devices[j], in the process owners[j]
        self.devices, owners = mesh.line_of(axis, me)
        mine = [j for j, r in enumerate(owners) if r == me]
        # the shards this process holds, [first, stop), and where its queries enter
        self.first, self.stop = mine[0], mine[-1] + 1
        self.query_device = self.devices[self.first]
        # candidates meet over the group when the index line holds every rank
        self.over_group = (mesh.ranks is not None
                           and set(owners) == set(range(distributed.world_size())))
        self.metric = metric
        self.block_rows = block_rows
        self.method = method
        self.recall_target = recall_target
        self.n_shards = mesh.shape[axis]
        self.ntotal = 0
        self.rows_per_shard = 0
        self.dtype = "float32"
        self.doc_ids: list[str] = []
        self._vectors: list[torch.Tensor] | None = None  # one tensor a shard held here
        self._scales: list[torch.Tensor] | None = None
        # recall-margin rescore: bf16 rows sharded like the quantized rows
        # (refine_m = 0 disables)
        self.refine_m = 0
        self._refine: list[torch.Tensor] | None = None
        # clustered: whole cells are sharded; _perm maps a reordered
        # position to its original row
        self._perm: np.ndarray | None = None
        self._centroids: list[torch.Tensor] | None = None
        self._rows_per_cell = 0
        self._n_cells = 0
        self.nprobe = 64

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------

    def _padded_rows(self, ntotal: int) -> int:
        if self._rows_per_cell:
            # clustered: shards own whole cells
            cps = -(-self._n_cells // self.n_shards)
            return cps * self._rows_per_cell
        per_shard = -(-ntotal // self.n_shards)
        return -(-per_shard // 128) * 128

    def _local_rows(self, ntotal: int) -> tuple[int, int]:
        """The global rows ``[lo, hi)`` of the valid rows that this process's
        shards hold."""
        per_shard = self._padded_rows(ntotal)
        return min(self.first * per_shard, ntotal), min(self.stop * per_shard, ntotal)

    def _shard_rows(self, read, ntotal: int, per_shard: int, width: int | None, dtype,
                    fill, bf16: bool = False) -> list[torch.Tensor]:
        """The rows of each shard this process holds (``width`` None: a
        vector) read from the unpadded source ``read(start, stop)``, ``fill``
        past ``ntotal``."""
        out = []
        for j in range(self.first, self.stop):
            device = self.devices[j]
            start, stop = j * per_shard, (j + 1) * per_shard
            shape = (per_shard,) if width is None else (per_shard, width)
            rows = np.full(shape, fill, dtype)
            valid_end = min(stop, ntotal)
            if start < valid_end:
                rows[: valid_end - start] = read(start, valid_end)
            out.append(_to_device(rows, bf16, device))
        return out

    def _place_from_source(
        self,
        read_rows,  # callable (start, stop) -> rows of the unpadded source
        dim: int,
        np_dtype,
        ntotal: int,
        doc_ids: Sequence[str],
        scales_read=None,  # callable (start, stop) -> scales, or None
        dtype: str = "float32",
        refine_read=None,  # callable (start, stop) -> bf16 bits, or None
        refine_m: int = 0,
        refine_dim: int | None = None,  # unpacked D (= dim unless int4)
    ) -> None:
        """Place rows straight into their shards; padding rows (global
        position >= ntotal) are zero, with scale 1.0."""
        per_shard = self._padded_rows(ntotal)
        bf16 = dtype == "bfloat16"
        self._vectors = self._shard_rows(read_rows, ntotal, per_shard, dim, np_dtype, 0, bf16)
        self._scales = (None if scales_read is None else
                        self._shard_rows(scales_read, ntotal, per_shard, None, np.float32, 1.0))
        if refine_read is not None and refine_m > 0:
            rdim = refine_dim if refine_dim is not None else dim
            self._refine = self._shard_rows(refine_read, ntotal, per_shard, rdim, np.uint16, 0,
                                            bf16=True)
            self.refine_m = int(refine_m)
        else:
            self._refine = None
            self.refine_m = 0
        self.ntotal = ntotal
        self.rows_per_shard = per_shard
        self.dtype = dtype
        self.doc_ids = [str(x) for x in doc_ids]

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def build_from_arrays(
        self,
        embeddings: np.ndarray,
        doc_ids: Sequence[str],
        dtype: str = "float32",
        refine_m: int = 0,
    ) -> "ShardedIndex":
        emb = np.asarray(embeddings, dtype=np.float32)
        n, d = emb.shape
        if len(doc_ids) != n:
            raise IndexBuildError("doc_ids length != embedding rows")
        if refine_m > 0 and dtype not in ("int8", "int4"):
            raise IndexBuildError("refine_m rescore applies to quantized rows (int8/int4)")
        if dtype not in ("float32", "bfloat16", "int8", "int4"):
            raise IndexBuildError(f"unsupported index dtype {dtype!r}")
        # only the rows of this process's shards: every step is row by row
        lo, hi = self._local_rows(n)
        emb = emb[lo:hi]
        if self.metric == "cosine":
            emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        refine = _bf16_bits(emb) if refine_m > 0 else None
        scales = None
        if dtype in ("int8", "int4"):
            # quantized on this process's first device, as the builder does on its own
            quantize = quantize_rows if dtype == "int8" else quantize_rows_int4
            values, scales_t = quantize(torch.from_numpy(emb).to(self.query_device))
            emb, scales = values.cpu().numpy(), scales_t.cpu().numpy()
        elif dtype == "bfloat16":
            emb = _bf16_bits(emb)
        self._place_from_source(
            lambda a, b: emb[a - lo:b - lo],
            emb.shape[1],  # D / 2 stored columns for packed int4
            emb.dtype,
            n,
            doc_ids,
            scales_read=None if scales is None else (lambda a, b: scales[a - lo:b - lo]),
            dtype=dtype,
            refine_read=None if refine is None else (lambda a, b: refine[a - lo:b - lo]),
            refine_m=refine_m,
            refine_dim=d,
        )
        logger.info(
            f"sharded index: ntotal={n} shards={self.n_shards} "
            f"rows/shard={self.rows_per_shard} dtype={dtype}"
            + (f" refine_m={refine_m}" if refine_m else "")
        )
        return self

    @classmethod
    def from_builder(cls, builder, mesh, axis: str = "index") -> "ShardedIndex":
        """Lift a single-device :class:`IndexBuilder` onto the mesh, from its
        stored (normalized, quantized or cast) rows as they are. A clustered
        index is sharded by whole cells and each shard probes ``nprobe`` of
        its own cells, so the shards together probe more cells than one
        device would (the FAISS ``IndexShards`` convention); it keeps no
        rescore stage."""
        idx = cls(mesh, axis=axis, metric=builder.metric, method=builder.index_type,
                  recall_target=builder.recall_target)
        if builder._perm is not None:
            idx._set_cluster(builder._perm, builder._centroids, builder._rows_per_cell,
                             builder.nprobe)
        vec, scales = builder._vectors, builder._scales
        refine = builder._refine if builder.index_type != "clustered" else None
        idx._place_from_source(
            lambda a, b: vec[a:b],
            vec.shape[1],
            vec.dtype,
            vec.shape[0],
            builder.doc_ids,
            scales_read=None if scales is None else (lambda a, b: scales[a:b]),
            dtype=builder.dtype,
            refine_read=None if refine is None else (lambda a, b: refine[a:b]),
            refine_m=builder.refine_m if refine is not None else 0,
            refine_dim=refine.shape[1] if refine is not None else None,
        )
        logger.info(
            f"sharded index from builder: ntotal={idx.ntotal} shards={idx.n_shards} "
            f"dtype={idx.dtype} {'clustered' if idx._perm is not None else idx.method}"
        )
        return idx

    def _set_cluster(self, perm: np.ndarray, centroids: np.ndarray, rows_per_cell: int,
                     nprobe: int) -> None:
        """Record the cell layout and place each shard's centroids (zero
        centroids pad the last shard; their rows are masked by position)."""
        self._perm = np.asarray(perm)
        self._rows_per_cell = int(rows_per_cell)
        self._n_cells = int(centroids.shape[0])
        self.nprobe = int(nprobe)
        cent = np.asarray(centroids, np.float32)
        cps = -(-self._n_cells // self.n_shards)
        self._centroids = self._shard_rows(lambda a, b: cent[a:b], self._n_cells, cps,
                                           cent.shape[1], np.float32, 0)

    # ------------------------------------------------------------------
    # Persistence (the sskd-sharded-1 layout)
    # ------------------------------------------------------------------

    def _unpadded(self, shards: list[torch.Tensor], n: int) -> np.ndarray:
        return np.concatenate([_to_host(t) for t in shards])[:n]

    def save(self, output_dir: str | Path) -> Path:
        if self._vectors is None:
            raise IndexBuildError("cannot save an empty sharded index")
        if self.stop - self.first < self.n_shards:
            raise IndexBuildError(
                f"cannot save an index whose {self.n_shards} shards lie in more than one "
                f"process (this one holds shards {self.first}..{self.stop - 1}): the JAX "
                "package's save fetches the whole array, which JAX refuses across processes. "
                "Save the index before sharding it, from a builder or a one-process mesh")
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        # unpadded rows: the layout does not depend on the mesh's shape
        full = self._unpadded(self._vectors, self.ntotal)
        if self.dtype == "bfloat16":
            _save_bf16(out / "vectors.npy", full)
        else:
            np.save(out / "vectors.npy", full)
        if self._scales is not None:
            np.save(out / "scales.npy", self._unpadded(self._scales, self.ntotal))
        if self._refine is not None:
            _save_bf16(out / "refine.npy", self._unpadded(self._refine, self.ntotal))
        with open(out / "doc_ids.json", "w") as f:
            json.dump(self.doc_ids, f)
        meta = {
            "embedding_dim": int(full.shape[1]),
            "metric": self.metric,
            "dtype": self.dtype,
            "method": self.method,
            "recall_target": self.recall_target,
            "ntotal": self.ntotal,
            "saved_n_shards": self.n_shards,
            "refine_m": self.refine_m if self._refine is not None else 0,
            "checksums": {
                "vectors": _file_sha256(out / "vectors.npy"),
                "doc_ids": hashlib.sha256(json.dumps(self.doc_ids).encode()).hexdigest(),
            },
        }
        if self._scales is not None:
            meta["checksums"]["scales"] = _file_sha256(out / "scales.npy")
        if self._refine is not None:
            meta["checksums"]["refine"] = _file_sha256(out / "refine.npy")
        if self._perm is not None:
            np.save(out / "perm.npy", self._perm)
            np.save(out / "centroids.npy", self._unpadded(self._centroids, self._n_cells))
            meta["cluster"] = {
                "rows_per_cell": self._rows_per_cell,
                "n_cells": self._n_cells,
                "nprobe": self.nprobe,
            }
            meta["checksums"]["perm"] = hashlib.sha256(self._perm.tobytes()).hexdigest()
        with open(out / "meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        (out / "INDEX_VERSION").write_text(SHARDED_INDEX_VERSION + "\n")
        logger.info(f"saved sharded index to {out} (ntotal={self.ntotal})")
        return out

    def load(self, index_dir: str | Path) -> "ShardedIndex":
        path = Path(index_dir)
        version_file = path / "INDEX_VERSION"
        if not version_file.exists():
            raise IndexLoadError(f"no INDEX_VERSION in {path}")
        version = version_file.read_text().strip()
        if version != SHARDED_INDEX_VERSION:
            raise IndexVersionError(
                f"index version {version!r} != supported {SHARDED_INDEX_VERSION!r}"
            )
        with open(path / "meta.json") as f:
            meta = json.load(f)
        if _file_sha256(path / "vectors.npy") != meta["checksums"]["vectors"]:
            raise IndexLoadError("vectors checksum mismatch — corrupt index")
        with open(path / "doc_ids.json") as f:
            doc_ids = json.load(f)
        if hashlib.sha256(json.dumps(doc_ids).encode()).hexdigest() != meta["checksums"]["doc_ids"]:
            raise IndexLoadError("doc_ids checksum mismatch — corrupt index")
        # memory-mapped: each shard reads only its own rows
        if meta["dtype"] == "bfloat16":
            vectors = _load_bf16(path / "vectors.npy", mmap_mode="r")
        else:
            vectors = np.load(path / "vectors.npy", mmap_mode="r")
        scales = None
        if (path / "scales.npy").exists():
            if _file_sha256(path / "scales.npy") != meta["checksums"].get("scales"):
                raise IndexLoadError("scales checksum mismatch — corrupt index")
            scales = np.load(path / "scales.npy", mmap_mode="r")
        refine = None
        refine_m = int(meta.get("refine_m", 0))
        if refine_m > 0:
            if not (path / "refine.npy").exists():
                raise IndexLoadError(
                    f"meta records refine_m {refine_m} > 0 but refine.npy is missing "
                    "— corrupt or partial index"
                )
            if _file_sha256(path / "refine.npy") != meta["checksums"].get("refine"):
                raise IndexLoadError("refine checksum mismatch — corrupt index")
            refine = _load_bf16(path / "refine.npy", mmap_mode="r")
        self.metric = meta["metric"]
        self.method = meta.get("method", "exact")
        self.recall_target = meta.get("recall_target", 0.99)
        if "cluster" in meta:
            perm = np.load(path / "perm.npy")
            if hashlib.sha256(perm.tobytes()).hexdigest() != meta["checksums"].get("perm"):
                raise IndexLoadError("perm checksum mismatch — corrupt index")
            self._set_cluster(perm, np.load(path / "centroids.npy"),
                              int(meta["cluster"]["rows_per_cell"]),
                              int(meta["cluster"]["nprobe"]))
        self._place_from_source(
            lambda a, b: vectors[a:b],
            int(meta["embedding_dim"]),
            vectors.dtype,
            int(meta["ntotal"]),
            doc_ids,
            scales_read=None if scales is None else (lambda a, b: scales[a:b]),
            dtype=meta["dtype"],
            refine_read=None if refine is None else (lambda a, b: refine[a:b]),
            refine_m=refine_m,
            refine_dim=refine.shape[1] if refine is not None else None,
        )
        logger.info(
            f"loaded sharded index from {path} (ntotal={self.ntotal}, "
            f"{meta['saved_n_shards']} saved shards -> {self.n_shards} mesh shards)"
        )
        return self

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def shard_search(self, k: int):
        """``program(queries, *index_args()) -> (vals [B, k], idx [B, k])``
        on :attr:`query_device`: the local top-k of each shard this process
        holds on its own device, over the group the gather of every rank's
        candidates, then the merge (see the module docstring). ``queries``
        are L2-normalized by the caller (:meth:`search`, the fused searcher);
        across processes every rank passes the same."""
        ntotal, rows_per_shard = self.ntotal, self.rows_per_shard
        block = min(self.block_rows, rows_per_shard)
        clustered = self._perm is not None
        has_refine = self._refine is not None and self.refine_m > 0 and not clustered
        refine_m, rpc, nprobe = self.refine_m, self._rows_per_cell, self.nprobe
        method, recall_target = self.method, self.recall_target
        has_scales = self._scales is not None
        over_group = self.over_group

        def local_search(q, j, shard, scales, cent, refine):
            offset = j * rows_per_shard
            local_valid = min(max(ntotal - offset, 0), rows_per_shard)
            if local_valid == 0:  # a shard of padding rows only
                return (q.new_full((q.shape[0], k), NEG_INF),
                        torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device))
            if has_refine:
                # the port's refined engine on the shard's rows, then the
                # rescore against the shard's own bf16 rows
                m = max(k, min(refine_m, rows_per_shard))
                _, cand = refined_candidates_core(q, shard, m, row_scales=scales,
                                                  valid_n=local_valid)
                vals, idx = rescore_candidates(q, refine, cand, k)
                return vals, offset_positions(idx, offset)
            if clustered and q.shape[0] <= CLUSTER_MAX_BATCH:
                return clustered_topk(q, shard, cent, k=k,
                                      nprobe=min(nprobe, shard.shape[0] // rpc),
                                      rows_per_cell=rpc, row_scales=scales, valid_n=ntotal,
                                      index_offset=offset)
            if not clustered and method == "exact" and kernel_exact_ok(q, shard, k):
                vals, idx = cosine_topk_kernels(q, shard, k, row_scales=scales,
                                                valid_n=local_valid)
                return vals, offset_positions(idx, offset)
            return cosine_topk(q, shard, k, block_rows=block, row_scales=scales,
                               valid_n=ntotal, index_offset=offset,
                               method="approx" if clustered else method,
                               recall_target=recall_target)

        def program(queries, vectors, *rest):
            rest = list(rest)
            scales = rest.pop(0) if has_scales else [None] * len(vectors)
            cents = rest.pop(0) if clustered else [None] * len(vectors)
            refines = rest.pop(0) if has_refine else [None] * len(vectors)
            home = queries.device
            parts_v, parts_i = [], []
            for i, j in enumerate(range(self.first, self.stop)):
                device = self.devices[j]
                with on_device(device):
                    vals, idx = local_search(queries.to(device), j, vectors[i], scales[i],
                                             cents[i], refines[i])
                parts_v.append(vals.to(home))
                parts_i.append(idx.to(home))
            # in shard order, as all_gather(..., tiled=True) lays them out
            vals, idx = torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1)
            if over_group:
                vals, idx = distributed.all_gather_candidates(vals, idx)
            return merge_topk(vals, idx, k)

        return program

    def index_args(self) -> tuple:
        """The tensors of the shards this process holds, to pass after the
        queries (matches :meth:`shard_search`)."""
        args = (self._vectors,)
        if self._scales is not None:
            args += (self._scales,)
        if self._centroids is not None:
            args += (self._centroids,)
        if self._refine is not None and self.refine_m > 0 and self._perm is None:
            args += (self._refine,)
        return args

    def map_positions(self, idx: np.ndarray) -> np.ndarray:
        """Merged engine positions -> original row positions (identity
        unless clustered, whose storage is cell-reordered)."""
        if self._perm is None:
            return idx
        idx = np.asarray(idx)
        safe = np.clip(idx, 0, len(self._perm) - 1)
        return np.where(idx >= 0, self._perm[safe], -1).astype(idx.dtype)

    def search(self, query_emb: np.ndarray, k: int = 10):
        """``(scores [B, k], positions [B, k])`` numpy, (-inf, -1) padded as
        the engines pad. Across processes every rank calls it with the same
        queries and gets the same result."""
        if self._vectors is None:
            raise IndexBuildError("index not built")
        q = np.asarray(query_emb, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        with torch.inference_mode():
            vals, idx = self.shard_search(k)(torch.from_numpy(q).to(self.query_device),
                                             *self.index_args())
        return vals.cpu().numpy(), self.map_positions(idx.cpu().numpy())
