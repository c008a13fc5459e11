"""The evaluation and training inputs of the pipeline (port of
``build_training_inputs`` and ``load_eval_inputs``,
sskd_tpu/cli/pipeline.py:29-127).

``load_eval_inputs`` gives ``(queries, corpus, qrels)`` for
:class:`~sskd_tpu_torch.kd.eval.KDEvaluator` from a raw JSONL split and its
``<split>.qrels.jsonl`` sidecar. The rest of the pipeline (fetch, prepare,
BM25, mining, training) is a later slice of the port.
"""

from __future__ import annotations

import json
from pathlib import Path

from sskd_tpu_torch.data.prepare import _iter_passages_graded


def build_training_inputs(raw_jsonl: Path, max_samples: int | None = None):
    """Step 5: queries, positive texts/ids, and the corpus from raw JSONL
    (reference: train_kd_pipeline.py:191-238 — positives are passages with
    is_selected == 1; corpus ids follow {qid}_passage_{i}).

    The corpus is deduplicated by exact text: MS-MARCO-style rows repeat
    passages across queries, and keeping every copy under its own id makes
    retrieval metrics penalize arbitrary tie-breaks between identical docs
    (a query's own copy ranks below an unlabeled twin). Every duplicate maps
    onto the first-seen canonical id.

    Returns (queries, positives, positive_ids, corpus, graded_rels) —
    graded_rels[i] maps doc_id -> relevance grade > 0 for query i (grade
    defaults to is_selected when the data carries no ``relevance_grade``
    list, so it is binary for real MS MARCO and graded for the demo set)."""
    queries: list[str] = []
    positives: list[list[str]] = []
    positive_ids: list[list[str]] = []
    graded_rels: list[dict[str, float]] = []
    corpus: dict[str, str] = {}
    text_to_id: dict[str, str] = {}
    with open(raw_jsonl) as f:
        for line in f:
            if max_samples and len(queries) >= max_samples:
                break
            row = json.loads(line)
            qid = str(row.get("query_id"))
            qtext = row.get("query", "")
            pos_texts, pos_ids = [], []
            rels: dict[str, float] = {}
            for pi, (text, selected, grade) in enumerate(
                _iter_passages_graded(row)
            ):
                doc_id = text_to_id.get(text)
                if doc_id is None:
                    doc_id = f"{qid}_passage_{pi}"
                    text_to_id[text] = doc_id
                    corpus[doc_id] = text
                if selected == 1:
                    pos_texts.append(text)
                    pos_ids.append(doc_id)
                if grade > 0:
                    rels[doc_id] = max(rels.get(doc_id, 0.0), grade)
            if pos_texts:
                queries.append(qtext)
                positives.append(pos_texts)
                positive_ids.append(pos_ids)
                graded_rels.append(rels)
    return queries, positives, positive_ids, corpus, graded_rels


def load_eval_inputs(raw_jsonl: str | Path, max_samples: int | None = None):
    """(queries, corpus, qrels) for retrieval eval. Prefers a TREC-style
    ``<split>.qrels.jsonl`` sidecar (cross-query ground truth, keyed by
    passage text — the demo generator emits one; see
    sskd_tpu/data/demo.py in the JAX package) and falls back to row-local graded labels.
    Row-local labels understate quality whenever another query's positive
    is interchangeable with this one (the unlabeled-duplicate trap)."""
    raw_jsonl = Path(raw_jsonl)
    queries, positives, positive_ids, corpus, graded = build_training_inputs(
        raw_jsonl, max_samples
    )
    q_map = {f"q{i}": q for i, q in enumerate(queries)}
    qrels = {f"q{i}": rels for i, rels in enumerate(graded)}

    # with_suffix replaces only the final extension, so this resolves for
    # any input suffix (demo.jsonl -> demo.qrels.jsonl, demo -> demo.qrels.jsonl)
    # instead of silently mangling non-.jsonl names.
    sidecar = raw_jsonl.with_suffix(".qrels.jsonl")
    if sidecar.exists():
        by_qid: dict = {}
        with open(sidecar) as f:
            for line in f:
                row = json.loads(line)
                by_qid[row["query_id"]] = row["rels"]
        # rows are consumed in file order, skipping positive-less ones —
        # recover each kept row's query_id to pair with the sidecar
        kept_qids = []
        with open(raw_jsonl) as f:
            for line in f:
                if max_samples and len(kept_qids) >= max_samples:
                    break
                row = json.loads(line)
                if any(s == 1 for _, s, _ in _iter_passages_graded(row)):
                    kept_qids.append(row.get("query_id"))
        text_to_id = {t: d for d, t in corpus.items()}
        for i, qid in enumerate(kept_qids):
            rels_by_text = by_qid.get(qid)
            if rels_by_text is not None:
                qrels[f"q{i}"] = {
                    text_to_id[t]: float(g)
                    for t, g in rels_by_text.items()
                    if t in text_to_id
                }
    return q_map, corpus, qrels
