"""Data integrity checks (port of sskd_tpu/data/integrity.py; reference:
src/data/integrity.py:14-269): SHA-256 file hashes, JSONL line counts vs
manifest, duplicate-ID scan, and required-field schema checks over prepared
parquet, read through :mod:`sskd_tpu_torch.data.parquet` where the JAX
package reads through pandas. The problem strings are the JAX package's."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from sskd_tpu_torch.data.parquet import parquet_columns, read_parquet
from sskd_tpu_torch.data.prepare import BEIR_COLUMNS, REQUIRED_COLUMNS
from sskd_tpu_torch.data.registry import (
    get_chunks_dir,
    get_chunks_path,
    get_manifest_path,
    get_raw_path,
    is_beir_dataset,
)
from sskd_tpu_torch.exceptions import DataIntegrityError
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("data.integrity")


def compute_file_hash(path: str | Path, algo: str = "sha256") -> str:
    """Streaming file hash (reference: integrity.py:14-35)."""
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def check_line_counts(data_dir: str | Path, dataset: str) -> list[str]:
    """JSONL line counts must match the fetch manifest
    (reference: integrity.py:38-64)."""
    problems = []
    manifest_path = get_manifest_path(data_dir, dataset)
    if not manifest_path.exists():
        return [f"missing manifest {manifest_path}"]
    with open(manifest_path) as f:
        manifest = json.load(f)
    for split, info in manifest.get("splits", {}).items():
        path = get_raw_path(data_dir, dataset, split)
        if not path.exists():
            problems.append(f"missing raw file {path}")
            continue
        with open(path) as f:
            n = sum(1 for _ in f)
        if n != info["num_samples"]:
            problems.append(f"{dataset}/{split}: {n} lines != manifest {info['num_samples']}")
    return problems


def check_no_duplicates(parquet_path: str | Path, id_column: str = "chunk_id") -> list[str]:
    """No duplicate chunk ids (reference: integrity.py:67-98). The examples
    are the first three duplicated ids in order of first repetition, as
    pandas' ``ids[ids.duplicated()].unique()`` lists them."""
    ids = read_parquet(parquet_path, columns=[id_column])[id_column]
    seen: set = set()
    dupes: dict = {}  # insertion-ordered set
    for i in ids:
        if i in seen:
            dupes.setdefault(i, None)
        else:
            seen.add(i)
    if dupes:
        dupes_list = list(dupes)
        return [f"{parquet_path}: {len(dupes_list)} duplicate {id_column}s "
                f"(e.g. {dupes_list[:3]})"]
    return []


def check_schema(parquet_path: str | Path, required: tuple[str, ...] | None = None) -> list[str]:
    """All required columns present, no nulls in keys
    (reference: integrity.py:101-132)."""
    present = parquet_columns(parquet_path)
    problems = []
    missing = set(required or REQUIRED_COLUMNS) - set(present)
    if missing:
        problems.append(f"{parquet_path}: missing columns {sorted(missing)}")
    wanted = [c for c in ("chunk_id", "doc_id", "text") if c in present]
    cols = read_parquet(parquet_path, columns=wanted) if wanted else {}
    for col in ("chunk_id", "doc_id", "text"):
        if col in cols and any(v is None for v in cols[col]):
            problems.append(f"{parquet_path}: nulls in {col}")
    if "text" in cols and any(v is not None and len(v) == 0 for v in cols["text"]):
        problems.append(f"{parquet_path}: empty text rows")
    return problems


def _report(dataset: str, problems: list[str]) -> dict:
    ok = not problems
    if ok:
        logger.info(f"integrity OK: {dataset}")
    else:
        for p in problems:
            logger.error(f"integrity: {p}")
    return {"ok": ok, "problems": problems}


def check_dataset_integrity(
    data_dir: str | Path, dataset: str, splits: tuple[str, ...] = ("train", "validation")
) -> dict:
    """Aggregate all checks (reference: integrity.py:135-269). Returns
    {"ok": bool, "problems": [...]}; raises nothing — callers decide.
    BEIR datasets check the single prepared ``corpus.parquet`` against the
    BEIR row schema instead of the per-split MS MARCO layout."""
    if is_beir_dataset(dataset):
        problems = []
        pq = get_chunks_dir(data_dir, dataset) / "corpus.parquet"
        if not pq.exists():
            problems.append(f"missing prepared parquet {pq}")
        else:
            problems += check_no_duplicates(pq)
            problems += check_schema(pq, required=BEIR_COLUMNS)
        return _report(dataset, problems)
    problems = check_line_counts(data_dir, dataset)
    for split in splits:
        pq = get_chunks_path(data_dir, dataset, split)
        if not pq.exists():
            problems.append(f"missing prepared parquet {pq}")
            continue
        problems += check_no_duplicates(pq)
        problems += check_schema(pq)
    return _report(dataset, problems)


def require_integrity(data_dir: str | Path, dataset: str, **kw) -> None:
    """Raise on any integrity failure (CLI exit path;
    the reference exited(1), integrity.py:213-269)."""
    report = check_dataset_integrity(data_dir, dataset, **kw)
    if not report["ok"]:
        raise DataIntegrityError(
            f"integrity check failed for {dataset}",
            details={"problems": report["problems"]},
        )
