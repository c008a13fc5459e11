"""Dataset registry (port of sskd_tpu/data/registry.py): canonical paths for
every dataset the pipeline touches (reference: src/data/registry.py:13-106 —
msmarco + 3 BEIR sets, raw/chunks/manifest layout, ensure_dirs)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from sskd_tpu_torch.exceptions import DatasetNotFoundError


@dataclass(frozen=True)
class DatasetConfig:
    name: str
    source: str  # HF hub id or "synthetic"
    splits: tuple[str, ...]
    description: str = ""


DATASETS: dict[str, DatasetConfig] = {
    "msmarco": DatasetConfig(
        name="msmarco",
        source="ms_marco/v2.1",
        splits=("train", "validation"),
        description="MS MARCO passage ranking v2.1",
    ),
    "fiqa": DatasetConfig(
        name="fiqa", source="BeIR/fiqa", splits=("test",), description="BEIR FiQA"
    ),
    "scifact": DatasetConfig(
        name="scifact",
        source="BeIR/scifact",
        splits=("test",),
        description="BEIR SciFact",
    ),
    "trec-covid": DatasetConfig(
        name="trec-covid",
        source="BeIR/trec-covid",
        splits=("test",),
        description="BEIR TREC-COVID",
    ),
    "demo": DatasetConfig(
        name="demo",
        source="synthetic",
        splits=("train", "validation"),
        description="bundled synthetic corpus for offline demo/e2e runs",
    ),
}


def get_dataset_config(name: str) -> DatasetConfig:
    if name not in DATASETS:
        raise DatasetNotFoundError(
            f"unknown dataset {name!r}", details={"known": sorted(DATASETS)}
        )
    return DATASETS[name]


def get_raw_dir(data_dir: str | Path, name: str) -> Path:
    return Path(data_dir) / "raw" / name


def get_chunks_dir(data_dir: str | Path, name: str) -> Path:
    return Path(data_dir) / "chunks" / name


def get_raw_path(data_dir: str | Path, name: str, split: str) -> Path:
    return get_raw_dir(data_dir, name) / f"{split}.jsonl"


def get_chunks_path(data_dir: str | Path, name: str, split: str) -> Path:
    return get_chunks_dir(data_dir, name) / f"{split}.parquet"


def get_manifest_path(data_dir: str | Path, name: str) -> Path:
    return get_raw_dir(data_dir, name) / "_manifest.json"


def ensure_dirs(data_dir: str | Path, name: str) -> None:
    get_raw_dir(data_dir, name).mkdir(parents=True, exist_ok=True)
    get_chunks_dir(data_dir, name).mkdir(parents=True, exist_ok=True)


def is_beir_dataset(name: str) -> bool:
    return get_dataset_config(name).source.startswith("BeIR/")


# BEIR raw layout (reference: src/data/fetch.py:69-90 + BEIR convention):
#   raw/{name}/corpus.jsonl   — {"doc_id"|"_id", "title", "text"}
#   raw/{name}/queries.jsonl  — {"query_id"|"_id", "text"}
#   raw/{name}/qrels/test.tsv — query-id \t corpus-id \t score


def get_beir_corpus_path(data_dir: str | Path, name: str) -> Path:
    return get_raw_dir(data_dir, name) / "corpus.jsonl"


def get_beir_queries_path(data_dir: str | Path, name: str) -> Path:
    return get_raw_dir(data_dir, name) / "queries.jsonl"


def get_beir_qrels_path(data_dir: str | Path, name: str, split: str = "test") -> Path:
    return get_raw_dir(data_dir, name) / "qrels" / f"{split}.tsv"
