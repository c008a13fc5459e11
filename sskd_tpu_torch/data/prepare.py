"""Raw JSONL -> chunked parquet preparation (port of sskd_tpu/data/prepare.py).

Handles both MS MARCO v2.1 layouts the reference handled
(reference: prepare.py:16-135): the nested
``passages{passage_text[], is_selected[]}`` dict and the legacy list of
passage dicts. Long passages are chunked with the sliding-window
TextChunker (512 tokens / stride 80 in the pipeline,
reference: scripts/train_kd_pipeline.py:139-151) and every chunk becomes a
row with the reference's schema:
``{chunk_id, doc_id, query_id, query_text, text, tokens, is_relevant,
split, updated_at}`` (reference: prepare.py row shape), written as
snappy parquet + ``_manifest.json``.

The JAX package writes and reads the parquet through pandas; the port goes
through :mod:`sskd_tpu_torch.data.parquet` (the machine with the GPU has no
pandas), so the files of either package read in the other.
:func:`load_beir_eval` returns the prepared corpus as ``{column: [values]}``
where the JAX package returns a DataFrame.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path

from sskd_tpu_torch.data.parquet import read_parquet, write_parquet
from sskd_tpu_torch.data.registry import (
    DATASETS,
    get_beir_corpus_path,
    get_beir_qrels_path,
    get_beir_queries_path,
    get_chunks_dir,
    get_raw_path,
    is_beir_dataset,
)
from sskd_tpu_torch.exceptions import DataError
from sskd_tpu_torch.utils.chunk import TextChunker
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("data.prepare")

REQUIRED_COLUMNS = (
    "chunk_id",
    "doc_id",
    "query_id",
    "query_text",
    "text",
    "tokens",
    "is_relevant",
    "split",
    "updated_at",
)
BEIR_COLUMNS = ("chunk_id", "doc_id", "title", "text", "tokens", "updated_at")


def _iter_passages(row: dict):
    """Yield (passage_text, is_selected) from either MS MARCO layout."""
    for text, sel, _grade in _iter_passages_graded(row):
        yield text, sel


def _iter_passages_graded(row: dict):
    """Yield (passage_text, is_selected, relevance_grade). The grade rides
    in an optional parallel ``relevance_grade`` list (the demo generator
    emits 2 = positive / 1 = hard near-miss / 0 = irrelevant for graded
    nDCG); without it (real MS MARCO) it is is_selected."""
    passages = row.get("passages")
    if passages is None:
        return
    if isinstance(passages, dict):  # v2.1 nested layout
        texts = passages.get("passage_text", [])
        selected = passages.get("is_selected", [0] * len(texts))
        grades = passages.get("relevance_grade", selected)
        for text, sel, grade in zip(texts, selected, grades):
            yield text, int(sel), float(grade)
    elif isinstance(passages, list):  # legacy list-of-dicts layout
        for p in passages:
            sel = int(p.get("is_selected", 0))
            yield p.get("passage_text", ""), sel, float(p.get("relevance_grade", sel))
    else:
        raise DataError(f"unrecognized passages layout: {type(passages)}")


def _columns(rows: list[dict], names) -> dict[str, list]:
    return {n: [r[n] for r in rows] for n in names}


def prepare_msmarco_split(
    data_dir: str | Path,
    split: str,
    dataset: str = "msmarco",
    chunker: TextChunker | None = None,
    max_tokens: int = 512,
    stride: int = 80,
    max_samples: int | None = None,
) -> Path:
    """One split: JSONL -> chunked parquet (reference: prepare.py:16-135)."""
    raw_path = get_raw_path(data_dir, dataset, split)
    if not raw_path.exists():
        raise DataError(f"raw split not found: {raw_path}")
    chunker = chunker or TextChunker(max_tokens=max_tokens, stride=stride)

    now = datetime.now(timezone.utc).isoformat()
    rows = []
    n_queries = 0
    with open(raw_path) as f:
        for line in f:
            if max_samples and n_queries >= max_samples:
                break
            row = json.loads(line)
            qid = str(row.get("query_id", n_queries))
            qtext = row.get("query", "")
            n_queries += 1
            for pi, (text, selected) in enumerate(_iter_passages(row)):
                doc_id = f"{qid}_passage_{pi}"
                for chunk in chunker.chunk_text(text) or []:
                    rows.append(
                        {
                            "chunk_id": f"{doc_id}_c{chunk.chunk_index}",
                            "doc_id": doc_id,
                            "query_id": qid,
                            "query_text": qtext,
                            "text": chunk.text,
                            "tokens": chunk.num_tokens,
                            "is_relevant": selected,
                            "split": split,
                            "updated_at": now,
                        }
                    )
    if not rows:
        raise DataError(f"no rows produced from {raw_path}")
    out_dir = get_chunks_dir(data_dir, dataset)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{split}.parquet"
    write_parquet(out_path, _columns(rows, REQUIRED_COLUMNS))
    logger.info(f"prepared {dataset}/{split}: {n_queries} queries -> {len(rows)} chunks")
    return out_path


def prepare_beir_corpus(
    data_dir: str | Path,
    dataset: str,
    chunker: TextChunker | None = None,
    max_tokens: int = 512,
    stride: int = 80,
    max_docs: int | None = None,
) -> Path:
    """BEIR corpus JSONL -> chunked parquet (reference: prepare.py:137-204).

    Input rows carry ``doc_id``/``_id``, ``title``, ``text``; title and text
    are joined, chunked, and written with the reference's BEIR row schema
    ``{chunk_id, doc_id, title, text, tokens, updated_at}`` to
    ``chunks/{dataset}/corpus.parquet``.
    """
    corpus_path = get_beir_corpus_path(data_dir, dataset)
    if not corpus_path.exists():
        raise DataError(f"BEIR corpus not found: {corpus_path}")
    chunker = chunker or TextChunker(max_tokens=max_tokens, stride=stride)

    now = datetime.now(timezone.utc).isoformat()
    rows = []
    n_docs = 0
    with open(corpus_path) as f:
        for line in f:
            if max_docs and n_docs >= max_docs:
                break
            try:
                data = json.loads(line)
            except json.JSONDecodeError:
                logger.warning("skipping malformed BEIR corpus line")
                continue
            doc_id = str(data.get("doc_id") or data.get("_id") or "")
            title = data.get("title", "") or ""
            text = data.get("text", "") or ""
            full_text = f"{title}\n{text}" if title else text
            if not full_text or not doc_id:
                continue
            n_docs += 1
            for chunk in chunker.chunk_text(full_text) or []:
                rows.append(
                    {
                        "chunk_id": f"{doc_id}_c{chunk.chunk_index}",
                        "doc_id": doc_id,
                        "title": title,
                        "text": chunk.text,
                        "tokens": chunk.num_tokens,
                        "updated_at": now,
                    }
                )
    if not rows:
        raise DataError(f"no rows produced from {corpus_path}")
    out_dir = get_chunks_dir(data_dir, dataset)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "corpus.parquet"
    write_parquet(out_path, _columns(rows, BEIR_COLUMNS))
    logger.info(f"prepared BEIR {dataset}: {n_docs} docs -> {len(rows)} chunks")
    return out_path


def load_beir_eval(data_dir: str | Path, dataset: str, max_queries: int | None = None):
    """Load the prepared BEIR eval inputs: (queries, chunks, qrels).

    queries: qid -> text (raw queries.jsonl); chunks: the prepared corpus
    parquet as ``{column: [values]}``; qrels: qid -> {doc_id: grade} from
    qrels/test.tsv (TREC format, optional header line).
    """
    chunks_path = get_chunks_dir(data_dir, dataset) / "corpus.parquet"
    if not chunks_path.exists():
        raise DataError(f"prepared BEIR corpus not found: {chunks_path} — run prepare first")
    chunks = read_parquet(chunks_path)

    queries: dict[str, str] = {}
    with open(get_beir_queries_path(data_dir, dataset)) as f:
        for line in f:
            row = json.loads(line)
            qid = str(row.get("query_id") or row.get("_id") or "")
            if qid:
                queries[qid] = row.get("text", "")
            if max_queries and len(queries) >= max_queries:
                break

    qrels: dict[str, dict[str, float]] = {}
    with open(get_beir_qrels_path(data_dir, dataset)) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or parts[0] in ("query-id", "qid"):
                continue
            qid, did, grade = parts[0], parts[1], parts[-1]
            try:
                qrels.setdefault(qid, {})[did] = float(grade)
            except ValueError:
                continue
    queries = {q: t for q, t in queries.items() if q in qrels}
    return queries, chunks, qrels


def _num_chunks(path: Path) -> int:
    return len(read_parquet(path, columns=["chunk_id"])["chunk_id"])


def prepare_dataset(
    data_dir: str | Path,
    dataset: str = "msmarco",
    splits: tuple[str, ...] = ("train", "validation"),
    max_tokens: int = 512,
    stride: int = 80,
    max_samples: int | None = None,
) -> dict:
    """All splits + manifest (reference: prepare.py:206-299). BEIR datasets
    dispatch to :func:`prepare_beir_corpus` (reference: prepare.py:244-249)."""
    chunker = TextChunker(max_tokens=max_tokens, stride=stride)
    manifest: dict = {"dataset": dataset, "splits": {}}
    if is_beir_dataset(dataset):
        path = prepare_beir_corpus(data_dir, dataset, chunker=chunker, max_docs=max_samples)
        manifest["splits"]["corpus"] = {"file": str(path), "num_chunks": _num_chunks(path)}
    else:
        for split in splits:
            path = prepare_msmarco_split(
                data_dir, split, dataset=dataset, chunker=chunker, max_samples=max_samples
            )
            manifest["splits"][split] = {"file": str(path), "num_chunks": _num_chunks(path)}
    out_dir = get_chunks_dir(data_dir, dataset)
    with open(out_dir / "_manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def prepare_all_datasets(
    data_dir: str | Path,
    datasets: tuple[str, ...] | None = None,
    max_tokens: int = 512,
    stride: int = 80,
) -> dict[str, dict]:
    """Prepare every registered dataset whose raw files are present,
    tolerating per-dataset failures (reference: prepare.py:264-289)."""
    out: dict[str, dict] = {}
    for name in datasets or tuple(DATASETS):
        try:
            out[name] = prepare_dataset(data_dir, dataset=name, max_tokens=max_tokens,
                                        stride=stride)
        except DataError as e:
            logger.warning(f"skipping {name}: {e}")
    return out
