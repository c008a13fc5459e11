"""Vector index on the device (port of sskd_tpu/index/builder.py).

The on-disk layout is the JAX package's, byte for byte, so either package
loads what the other saved::

    index_dir/
      INDEX_VERSION      — layout version string
      meta.json          — dim / metric / dtype / index_type / ntotal + checksums
      vectors.npy        — [N, D] f32, bf16, int8 values, or [N, D/2] packed int4
      scales.npy         — [N] f32 per-row scales (int8 / int4)
      norms.npy          — [N] f32 original row norms
      refine.npy         — [N, D] bf16 refine rows (int8 / int4 with refine_m > 0)
      doc_ids.json       — position -> doc id
      texts.json         — optional doc texts for serving
      perm.npy, centroids.npy — clustered indexes only

``index_type``: ``"exact"`` and ``"approx"`` over float32, bfloat16, int8 or
int4 rows (:func:`sskd_tpu_torch.ops.topk.cosine_topk`), and ``"clustered"``
over float32, bfloat16 or int8 rows stored cell by cell with their
permutation and centroids (:func:`sskd_tpu_torch.ops.topk_cluster.clustered_topk`
up to ``CLUSTER_MAX_BATCH`` queries, the approx sweep over the reordered rows
above that, as the JAX package dispatches). An int8 or int4 index built with
``refine_m > 0`` keeps bf16 copies of its rows; an ``approx`` one is then
searched by the refined engine (:func:`sskd_tpu_torch.ops.topk.refined_topk`),
with the rows on the device or, at ``refine_storage="host"``, on the host
(:meth:`IndexBuilder._host_rescore`). Unlike the TPU path, the device copy of
the rows is padded only for a clustered index, to whole cells (zero rows with
scale 1.0, masked by their position): the kernels mask a ragged tail
themselves.

bf16 without ``ml_dtypes`` (which the machine with the card lacks): rows are
kept in numpy as their bits (``uint16``) and on the device as
``torch.bfloat16``; f32 rows convert through ``torch`` (round to nearest
even, as ``ml_dtypes`` rounds). The JAX package saves bf16 with ``np.save``
as descr ``'<V2'``, which ``np.load`` reads as two-byte voids; the port reads
those bytes as ``uint16`` and writes ``'<V2'`` in turn, so that the JAX
loader's ``dtype.kind == "V"`` test still recognises the rows. Checksums are
of the bytes, the same on both sides.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sskd_tpu_torch.exceptions import IndexBuildError, IndexLoadError, IndexVersionError
from sskd_tpu_torch.ops.quant import dequantize_rows, dequantize_rows_int4
from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4
from sskd_tpu_torch.ops.cluster import auto_cells, build_clusters
from sskd_tpu_torch.ops.topk import (
    cosine_topk,
    cosine_topk_core,
    refined_candidates,
    refined_topk,
    rescore_candidates,
)
from sskd_tpu_torch.ops.topk_cluster import CLUSTER_MAX_BATCH, clustered_topk
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.utils.platform import resolve_device

INDEX_VERSION = "sskd-exact-1"
BF16_DESCR = "<V2"  # what np.save writes for ml_dtypes.bfloat16

logger = get_logger("index")


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _bf16_bits(rows: np.ndarray) -> np.ndarray:
    """f32 rows rounded to bf16 (nearest even), as their bits ``uint16``."""
    t = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """The bf16 tensor over ``bits`` (uint16) on the CPU, sharing its memory."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _save_bf16(path: Path, bits: np.ndarray) -> None:
    """``bits`` (uint16) as a ``.npy`` of descr ``'<V2'``, byte for byte what
    ``np.save`` writes for the same rows as ``ml_dtypes.bfloat16``."""
    bits = np.ascontiguousarray(bits)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False, "shape": bits.shape}
        )
        f.write(bits.tobytes())


def _load_bf16(path: Path, mmap_mode: str | None = None) -> np.ndarray:
    """A saved bf16 array (two-byte voids, or uint16) as its bits ``uint16``."""
    arr = np.load(path, mmap_mode=mmap_mode)
    if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vu":
        raise IndexLoadError(f"{path.name}: expected bf16 rows, found {arr.dtype}")
    return arr.view(np.uint16)


def _ids_sha256(doc_ids: list[str]) -> str:
    return hashlib.sha256(json.dumps(doc_ids).encode()).hexdigest()


class IndexBuilder:
    """Cosine/dot top-k index over a device-resident matrix."""

    def __init__(
        self,
        embedding_dim: int = 384,
        index_type: str = "exact",
        metric: str = "cosine",
        dtype: str = "float32",
        block_rows: int = 262144,
        recall_target: float = 0.99,
        cluster_rows: int = 0,
        nprobe: int = 64,
        refine_m: int = 0,
        refine_storage: str = "device",
        device: str | torch.device | None = "cuda",
    ):
        """``cluster_rows``: target rows per cell of a clustered index (0 =
        auto, about sqrt(N)); ``nprobe``: cells probed per query, a
        query-time knob that ``save`` records and ``load`` restores.
        ``refine_m`` (int8 / int4): keep bf16 copies of the rows, and search
        an ``approx`` index in two stages, the quantized sweep fetching
        ``refine_m`` candidates whose bf16 rows are rescored (0 disables).
        ``refine_storage``: where the bf16 rows live when searched,
        ``"device"`` or ``"host"`` (rescored on the host; frees 2 bytes a
        value of device memory); a deployment choice, not saved."""
        if metric not in ("cosine", "dot"):
            raise IndexBuildError(f"unsupported metric {metric!r}")
        if dtype not in ("float32", "bfloat16", "int8", "int4"):
            raise IndexBuildError(f"unsupported index dtype {dtype!r}")
        if index_type not in ("exact", "approx", "clustered"):
            raise IndexBuildError(f"unsupported index_type {index_type!r}")
        if refine_storage not in ("device", "host"):
            raise IndexBuildError(f"unsupported refine_storage {refine_storage!r}")
        if dtype == "int4" and index_type == "clustered":
            raise IndexBuildError(
                "int4 storage is not supported with the clustered engine "
                "(the cell-gather kernels read unpacked rows)"
            )
        self.embedding_dim = embedding_dim
        self.index_type = index_type
        self.metric = metric
        self.dtype = dtype
        self.block_rows = block_rows
        self.recall_target = recall_target
        self.cluster_rows = cluster_rows
        self.nprobe = nprobe
        self.refine_m = refine_m
        self._refine_storage = refine_storage
        self.device = resolve_device(device)
        self.doc_ids: list[str] = []
        self.texts: list[str] | None = None
        self._vectors: np.ndarray | None = None  # f32, int8, packed int4, or bf16 bits
        self._scales: np.ndarray | None = None
        self._refine: np.ndarray | None = None  # bf16 bits of the rows (refine_m > 0)
        self._norms: np.ndarray | None = None
        self._perm: np.ndarray | None = None
        self._centroids: np.ndarray | None = None
        self._rows_per_cell = 0
        self.device_vectors: torch.Tensor | None = None  # placed by ensure_device
        self.device_scales: torch.Tensor | None = None
        self.device_centroids: torch.Tensor | None = None
        self.device_refine: torch.Tensor | None = None  # refine rows at "device" storage

    @property
    def refine_storage(self) -> str:
        return self._refine_storage

    @refine_storage.setter
    def refine_storage(self, value: str) -> None:
        """A query-time knob: setting it moves the refine rows to the device
        (``"device"``) or drops the device copy (``"host"``) at once, once the
        index has been placed, so that no search serves the old placement."""
        if value not in ("device", "host"):
            raise IndexBuildError(f"unsupported refine_storage {value!r}")
        self._refine_storage = value
        if self.device_vectors is not None:
            self.device_refine = self._placed_refine()

    def _placed_refine(self) -> torch.Tensor | None:
        if self._refine is None or self._refine_storage != "device":
            return None
        return _bf16_tensor(self._refine).to(self.device)

    @property
    def ntotal(self) -> int:
        return 0 if self._vectors is None else int(self._vectors.shape[0])

    @property
    def is_built(self) -> bool:
        return self._vectors is not None

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def build_from_arrays(
        self,
        embeddings: np.ndarray,
        doc_ids: Sequence[str],
        texts: Sequence[str] | None = None,
    ) -> "IndexBuilder":
        """Build from precomputed embeddings [N, D]. Quantization runs on
        the builder's device."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.embedding_dim:
            raise IndexBuildError(f"embeddings shape {emb.shape} != [N, {self.embedding_dim}]")
        if len(doc_ids) != emb.shape[0]:
            raise IndexBuildError("doc_ids length != embedding rows")
        norms = np.linalg.norm(emb, axis=1)
        if self.metric == "cosine":
            emb = emb / np.maximum(norms[:, None], 1e-12)
        self._norms = norms.astype(np.float32)  # original row order
        if self.index_type == "clustered":
            n_cells, rpc = auto_cells(emb.shape[0], self.cluster_rows)
            self._perm, self._centroids = build_clusters(emb, n_cells, rpc)
            self._rows_per_cell = rpc
            emb = emb[self._perm]  # cell-contiguous storage
        else:
            self._perm, self._centroids, self._rows_per_cell = None, None, 0
        if self.dtype in ("int8", "int4"):
            quantize = quantize_rows if self.dtype == "int8" else quantize_rows_int4
            values, scales = quantize(torch.from_numpy(emb).to(self.device))
            self._vectors = values.cpu().numpy()
            self._scales = scales.cpu().numpy()
            self._refine = _bf16_bits(emb) if self.refine_m > 0 else None
        else:
            self._vectors = _bf16_bits(emb) if self.dtype == "bfloat16" else emb
            self._scales = None
            self._refine = None
        self.doc_ids = [str(d) for d in doc_ids]
        self.texts = list(texts) if texts is not None else None
        self.device_vectors = None
        logger.info(f"built index: ntotal={self.ntotal} dtype={self.dtype}")
        return self

    def build_from_parquet(
        self,
        model,
        parquet_path: str | Path,
        batch_size: int = 256,
        max_docs: int | None = None,
        text_column: str = "text",
        id_column: str = "chunk_id",
    ) -> "IndexBuilder":
        """Encode a prepared corpus parquet (read by the port's own reader,
        ``data/parquet.py``) with ``model.encode_documents`` and build."""
        from sskd_tpu_torch.data.parquet import read_parquet

        cols = read_parquet(parquet_path, columns=[id_column, text_column])
        texts, ids = cols[text_column], [str(d) for d in cols[id_column]]
        if max_docs:
            texts, ids = texts[:max_docs], ids[:max_docs]
        emb = model.encode_documents(texts, batch_size=batch_size)
        return self.build_from_arrays(np.asarray(emb), ids, texts=texts)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save(self, output_dir: str | Path) -> Path:
        if not self.is_built:
            raise IndexBuildError("cannot save an empty index")
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        if self.dtype == "bfloat16":
            _save_bf16(out / "vectors.npy", self._vectors)
        else:
            np.save(out / "vectors.npy", self._vectors)
        if self._scales is not None:
            np.save(out / "scales.npy", self._scales)
        if self._norms is not None:
            np.save(out / "norms.npy", self._norms)
        with open(out / "doc_ids.json", "w") as f:
            json.dump(self.doc_ids, f)
        if self.texts is not None:
            with open(out / "texts.json", "w") as f:
                json.dump(self.texts, f)
        if self._refine is not None:
            _save_bf16(out / "refine.npy", self._refine)
        if self._perm is not None:
            np.save(out / "perm.npy", self._perm)
            np.save(out / "centroids.npy", self._centroids)
        meta = {
            "embedding_dim": self.embedding_dim,
            "index_type": self.index_type,
            "recall_target": self.recall_target,
            "metric": self.metric,
            "dtype": self.dtype,
            "refine_m": self.refine_m if self._refine is not None else 0,
            "ntotal": self.ntotal,
            "checksums": {
                "vectors": _sha256(self._vectors),
                "doc_ids": _ids_sha256(self.doc_ids),
            },
        }
        if self._refine is not None:
            meta["checksums"]["refine"] = _sha256(self._refine)
        if self._perm is not None:
            meta["cluster"] = {
                "rows_per_cell": self._rows_per_cell,
                "n_cells": int(self._centroids.shape[0]),
                "nprobe": self.nprobe,
            }
            meta["checksums"]["perm"] = _sha256(self._perm)
        with open(out / "meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        (out / "INDEX_VERSION").write_text(INDEX_VERSION + "\n")
        logger.info(f"saved index to {out} (ntotal={self.ntotal})")
        return out

    def load(self, index_dir: str | Path) -> "IndexBuilder":
        path = Path(index_dir)
        version_file = path / "INDEX_VERSION"
        if not version_file.exists():
            raise IndexLoadError(f"no INDEX_VERSION in {path}")
        version = version_file.read_text().strip()
        if version != INDEX_VERSION:
            raise IndexVersionError(f"index version {version!r} != supported {INDEX_VERSION!r}")
        with open(path / "meta.json") as f:
            meta = json.load(f)
        if meta["dtype"] == "bfloat16":
            vectors = _load_bf16(path / "vectors.npy")
        else:
            vectors = np.load(path / "vectors.npy")
        if _sha256(vectors) != meta["checksums"]["vectors"]:
            raise IndexLoadError("vectors checksum mismatch — corrupt index")
        with open(path / "doc_ids.json") as f:
            doc_ids = json.load(f)
        if _ids_sha256(doc_ids) != meta["checksums"]["doc_ids"]:
            raise IndexLoadError("doc_ids checksum mismatch — corrupt index")
        self.embedding_dim = meta["embedding_dim"]
        self.metric = meta["metric"]
        self.dtype = meta["dtype"]
        self.index_type = meta.get("index_type", "exact")
        self.recall_target = meta.get("recall_target", 0.99)
        self.refine_m = int(meta.get("refine_m", 0))
        self._refine = None
        if self.refine_m > 0:
            # a missing refine file is as corrupt as a checksum mismatch: the
            # plain quantized sweep would quietly lose the recall it was built for
            if not (path / "refine.npy").exists():
                raise IndexLoadError(
                    f"meta records refine_m {self.refine_m} > 0 but refine.npy is missing "
                    "— corrupt or partially-written index"
                )
            refine = _load_bf16(path / "refine.npy")
            if _sha256(refine) != meta["checksums"].get("refine"):
                raise IndexLoadError("refine checksum mismatch — corrupt index")
            self._refine = refine
        self._vectors = vectors
        self._scales = np.load(path / "scales.npy") if (path / "scales.npy").exists() else None
        self._norms = np.load(path / "norms.npy") if (path / "norms.npy").exists() else None
        self.doc_ids = [str(d) for d in doc_ids]
        texts_file = path / "texts.json"
        if texts_file.exists():
            with open(texts_file) as f:
                self.texts = json.load(f)
        else:
            self.texts = None
        if "cluster" in meta:
            self._perm = np.load(path / "perm.npy")
            if _sha256(self._perm) != meta["checksums"].get("perm"):
                raise IndexLoadError("perm checksum mismatch — corrupt index")
            self._centroids = np.load(path / "centroids.npy")
            self._rows_per_cell = int(meta["cluster"]["rows_per_cell"])
            self.nprobe = int(meta["cluster"]["nprobe"])
        else:
            self._perm = None
            self._centroids = None
            self._rows_per_cell = 0
        self.device_vectors = None
        self.device_refine = None
        logger.info(f"loaded index from {path} (ntotal={self.ntotal})")
        return self

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def check_searchable(self) -> None:
        """Raise unless the index can be searched."""
        if not self.is_built:
            raise IndexLoadError("index not built/loaded")
        if self.index_type == "clustered" and (self._perm is None or self.dtype == "int4"):
            raise IndexLoadError("a clustered index needs its cell layout and unpacked rows")

    def ensure_device(self) -> None:
        """Copy the rows (and scales, centroids, and refine rows at
        ``refine_storage="device"``) to the index's device once. The rows of a
        cell-reordered index are padded to ``n_cells * rows_per_cell`` with
        zero rows of scale 1.0, so that the last cell is whole; searches mask
        positions ``>= ntotal``."""
        if self.device_vectors is None:
            if self.dtype == "bfloat16":
                vec = _bf16_tensor(self._vectors).to(self.device)
            else:
                vec = torch.from_numpy(self._vectors).to(self.device)
            scales = (
                torch.from_numpy(self._scales).to(self.device)
                if self._scales is not None
                else None
            )
            if self._perm is not None:
                pad = self._centroids.shape[0] * self._rows_per_cell - vec.shape[0]
                if pad > 0:
                    vec = torch.cat([vec, vec.new_zeros((pad, vec.shape[1]))])
                    if scales is not None:
                        scales = torch.cat([scales, scales.new_ones(pad)])
                self.device_centroids = torch.from_numpy(self._centroids).to(self.device)
            else:
                self.device_centroids = None
            self.device_vectors, self.device_scales = vec, scales
            self.device_refine = self._placed_refine()

    def search(self, query_emb: np.ndarray, k: int = 10):
        """Top-k search. ``query_emb`` [B, D] (or [D]); returns (scores [B, k],
        indices [B, k]) numpy, (-inf, -1) padded. An ``approx`` index with
        refine rows is searched by the refined engine, on the device or with
        the rescore on the host (``refine_storage``); an exact or clustered
        one by its own engine, as the JAX package's ``search`` does (the
        served path refines any non-clustered index with refine rows:
        ``serve/fused.py``)."""
        self.check_searchable()
        q = np.asarray(query_emb, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.embedding_dim:
            raise IndexBuildError(f"query dim {q.shape[1]} != index dim {self.embedding_dim}")
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        self.ensure_device()
        q_dev = torch.from_numpy(q).to(self.device)
        if self._refine is not None and self.index_type == "approx":
            if self.refine_storage == "host":
                _, cand = refined_candidates(
                    q_dev, self.device_vectors, max(k, min(self.refine_m, self.ntotal)),
                    row_scales=self.device_scales, valid_n=self.ntotal,
                )
                return self._host_rescore(q, cand.cpu().numpy(), k)
            vals, idx = refined_topk(
                q_dev, self.device_vectors, self.device_refine, k, refine_m=self.refine_m,
                row_scales=self.device_scales, valid_n=self.ntotal,
            )
            return vals.cpu().numpy(), idx.cpu().numpy()
        if self.index_type == "clustered" and q.shape[0] <= CLUSTER_MAX_BATCH:
            vals, idx = clustered_topk(
                q_dev,
                self.device_vectors,
                self.device_centroids,
                k=k,
                nprobe=self.nprobe,
                rows_per_cell=self._rows_per_cell,
                row_scales=self.device_scales,
                valid_n=self.ntotal,
            )
        else:
            # a clustered index above CLUSTER_MAX_BATCH queries: the probes'
            # union nears the whole corpus, so the approx sweep over the
            # reordered rows answers (the JAX package's dispatch)
            vals, idx = cosine_topk(
                q_dev,
                self.device_vectors,
                k=k,
                block_rows=min(self.block_rows, max(128, self.ntotal)),
                row_scales=self.device_scales,
                valid_n=self.ntotal,
                method="approx" if self.index_type == "clustered" else self.index_type,
                recall_target=self.recall_target,
            )
        return vals.cpu().numpy(), self.map_positions(idx.cpu().numpy())

    def _host_rescore(self, q: np.ndarray, cand: np.ndarray, k: int):
        """The refine rows' rescore on the host (``refine_storage="host"``):
        the engine's rescore (:func:`sskd_tpu_torch.ops.topk.rescore_candidates`)
        on the CPU, over the candidates' bf16 rows and the (normalized)
        queries. Returns numpy (vals, idx), -inf and -1 where no candidate
        is, as the JAX package's host rescore returns them."""
        vals, idx = rescore_candidates(
            torch.from_numpy(np.asarray(q, dtype=np.float32)), _bf16_tensor(self._refine),
            torch.from_numpy(np.asarray(cand)), k,
        )
        return torch.where(idx >= 0, vals, -math.inf).numpy(), idx.numpy()

    def map_positions(self, idx: np.ndarray) -> np.ndarray:
        """Engine positions -> original row positions (identity unless the
        rows are stored cell-reordered, as a clustered index's are)."""
        if self._perm is None:
            return idx
        idx = np.asarray(idx)
        safe = np.clip(idx, 0, len(self._perm) - 1)
        return np.where(idx >= 0, self._perm[safe], -1).astype(idx.dtype)

    def position_of(self, doc_id: str) -> int | None:
        """The position of a doc id (None when unknown); the inverse map is
        built on first use and again when the ids change."""
        pos = getattr(self, "_pos_by_id", None)
        if pos is None or len(pos) != len(self.doc_ids):
            self._pos_by_id = pos = {d: i for i, d in enumerate(self.doc_ids)}
        return pos.get(doc_id)

    def get_texts(self, indices: Sequence[int]) -> list[str | None]:
        return [
            self.texts[i] if self.texts is not None and 0 <= i < len(self.texts) else None
            for i in indices
        ]

    # ------------------------------------------------------------------
    # Validation gate
    # ------------------------------------------------------------------

    def validate(self, n_queries: int = 1000, k: int = 10, seed: int = 0) -> dict[str, float]:
        """Build-time recall gate (the JAX package's recipe): recall@k of the
        index's search against exact f32 search over the bf16 refine rows
        where there are any (they are the original rows, so the gate credits
        the rescore), else the dequantized or widened stored rows, for
        ``n_queries`` probes made of corpus rows plus N(0, 0.05) noise.
        Both searches run on the index's device. A clustered index is
        probed ``CLUSTER_MAX_BATCH`` queries at a time, so that the gate
        measures the cell-probe path and not the large-batch sweep."""
        self.check_searchable()
        rng = np.random.default_rng(seed)
        n = min(n_queries, self.ntotal)
        probe_rows = rng.choice(self.ntotal, size=n, replace=False)
        self.ensure_device()
        rows = self.device_vectors[: self.ntotal]  # without a clustered index's padding
        scales = self.device_scales[: self.ntotal] if self.device_scales is not None else None
        if self._refine is not None:
            full = _bf16_tensor(self._refine).to(self.device).to(torch.float32)
        elif self.dtype == "int8":
            full = dequantize_rows(rows, scales)
        elif self.dtype == "int4":
            full = dequantize_rows_int4(rows, scales)
        else:
            full = rows.to(torch.float32)
        noise = torch.from_numpy(rng.normal(0, 0.05, (n, self.embedding_dim)).astype(np.float32))
        queries = full[torch.from_numpy(probe_rows).to(self.device)] + noise.to(self.device)
        queries = queries / queries.norm(dim=1, keepdim=True).clamp(min=1e-12)
        _, gt_top = cosine_topk_core(queries, full, k)
        gt_top = self.map_positions(gt_top.cpu().numpy())
        queries = queries.cpu().numpy()
        step = CLUSTER_MAX_BATCH if self.index_type == "clustered" else max(n, 1)
        idx = np.concatenate(
            [self.search(queries[i : i + step], k=k)[1] for i in range(0, n, step)]
        )
        recall = float(np.mean([len(set(gt_top[i]) & set(idx[i])) / k for i in range(n)]))
        return {"recall@%d" % k: recall, "n_queries": float(n)}
