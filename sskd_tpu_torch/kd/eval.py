"""KDEvaluator — retrieval quality, ranking quality, model comparison (port
of sskd_tpu/kd/eval.py:37-318).

The reference surface (reference: src/kd/eval.py:21-334):

- ``evaluate_retrieval``: encode the corpus once, rank every query through
  the exact top-k engine (:func:`~sskd_tpu_torch.ops.topk.cosine_topk`: the
  ``binmax`` / ``bin_gather`` kernels on the card where its gate holds), and
  average nDCG / MRR / recall / precision at {1, 5, 10, 20};
- ``evaluate_retrieval_chunked``: the same over a chunked corpus, chunk
  scores MaxSim-aggregated to documents;
- ``evaluate_retrieval_teacher`` / ``evaluate_retrieval_reranked``: the
  cross-encoder ranking the corpus, and re-ordering the student's top
  ``rerank_k``;
- ``evaluate_ranking_quality``: Kendall tau against the teacher's scores,
  and ECE of min-max normalized student scores;
- ``compare_models``: KD vs vanilla vs teacher with the acceptance gate
  "KD >= 95 % of teacher nDCG@10" (reference:
  scripts/evaluate_and_compare.py:129-134);
- ``generate_report``: markdown (reference: eval.py:302-334).

Differences from the JAX package:
- ``device`` (default ``"cuda"``, never guessed) is where the embeddings go
  to be ranked; ``device="cpu"`` ranks them with the plain engine;
- ``compare_models`` returns ``(rows, gate)`` where the JAX package returns
  ``(DataFrame, gate)``: ``rows`` maps each model's name to its metrics,
  ``DataFrame.to_dict(orient="index")`` of the JAX result (the machine with
  the GPU has no pandas).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from sskd_tpu_torch.ops.topk import cosine_topk
from sskd_tpu_torch.utils.chunk import maxsim_aggregate_topk
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.utils.metrics import (
    compute_retrieval_metrics,
    expected_calibration_error,
    kendall_tau,
)
from sskd_tpu_torch.utils.platform import resolve_device

logger = get_logger("kd.eval")

DEFAULT_KS = (1, 5, 10, 20)


def block_rows_for(n: int) -> int:
    """The ``block_rows`` the JAX evaluator ranks an ``n``-row corpus with."""
    return min(32768, max(128, n))


class KDEvaluator:
    def __init__(self, k_values: Sequence[int] = DEFAULT_KS, batch_size: int = 256,
                 device: str | torch.device | None = "cuda"):
        self.k_values = tuple(k_values)
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def _topk(self, q_emb: np.ndarray, doc_emb: np.ndarray, k: int):
        """(scores, positions) of the top ``k`` documents of each query, as
        numpy, ranked on the evaluator's device."""
        q = torch.from_numpy(np.ascontiguousarray(q_emb, np.float32)).to(self.device)
        d = torch.from_numpy(np.ascontiguousarray(doc_emb, np.float32)).to(self.device)
        vals, idx = cosine_topk(q, d, k=k, block_rows=block_rows_for(d.shape[0]))
        return vals.cpu().numpy(), idx.cpu().numpy()

    # ------------------------------------------------------------------

    def evaluate_retrieval(
        self,
        model,
        queries: Mapping[str, str],
        corpus: Mapping[str, str],
        qrels: Mapping[str, Mapping[str, float]],
    ) -> dict[str, float]:
        """Corpus-level retrieval metrics.

        queries: qid -> text; corpus: did -> text; qrels: qid -> {did: grade}.
        """
        doc_ids = list(corpus.keys())
        doc_emb = model.encode_documents([corpus[d] for d in doc_ids], batch_size=self.batch_size)
        qids = list(queries.keys())
        q_emb = model.encode_queries([queries[q] for q in qids], batch_size=self.batch_size)
        max_k = min(max(self.k_values), len(doc_ids))
        _, top_idx = self._topk(q_emb, doc_emb, max_k)

        results: dict[str, list[float]] = {}
        total_relevant: dict[str, int] = {}
        for qi, qid in enumerate(qids):
            rels = qrels.get(qid, {})
            results[qid] = [
                float(rels.get(doc_ids[di], 0.0)) if di >= 0 else 0.0 for di in top_idx[qi]
            ]
            total_relevant[qid] = sum(1 for v in rels.values() if v > 0)
        return compute_retrieval_metrics(results, total_relevant, ks=self.k_values)

    # ------------------------------------------------------------------

    def evaluate_retrieval_chunked(
        self,
        model,
        queries: Mapping[str, str],
        chunk_texts: Sequence[str],
        chunk_doc_ids: Sequence[str],
        qrels: Mapping[str, Mapping[str, float]],
        fetch_multiplier: int = 4,
    ) -> dict[str, float]:
        """Doc-level retrieval over a chunked corpus (the BEIR path,
        reference: prepare.py:137-204 corpus rows): rank the chunks with the
        exact top-k engine, MaxSim-aggregate chunk scores to documents, and
        score the doc ranking against doc-level qrels."""
        doc_emb = model.encode_documents(list(chunk_texts), batch_size=self.batch_size)
        qids = list(queries.keys())
        q_emb = model.encode_queries([queries[q] for q in qids], batch_size=self.batch_size)
        max_k = max(self.k_values)
        fetch_k = min(max_k * fetch_multiplier, len(chunk_texts))
        top_vals, top_idx = self._topk(q_emb, doc_emb, fetch_k)

        chunk_doc_ids = list(chunk_doc_ids)
        results: dict[str, list[float]] = {}
        total_relevant: dict[str, int] = {}
        for qi, qid in enumerate(qids):
            valid = top_idx[qi] >= 0
            _, doc_rank = maxsim_aggregate_topk(
                top_vals[qi][valid], [chunk_doc_ids[i] for i in top_idx[qi][valid]], k=max_k
            )
            rels = qrels.get(qid, {})
            results[qid] = [float(rels.get(d, 0.0)) for d in doc_rank]
            total_relevant[qid] = sum(1 for v in rels.values() if v > 0)
        return compute_retrieval_metrics(results, total_relevant, ks=self.k_values)

    # ------------------------------------------------------------------

    def evaluate_retrieval_teacher(
        self,
        teacher,
        queries: Mapping[str, str],
        corpus: Mapping[str, str],
        qrels: Mapping[str, Mapping[str, float]],
        batch_size: int = 256,
    ) -> dict[str, float]:
        """Cross-encoder retrieval quality: rank the corpus per query by
        teacher score. This is the teacher row of the reference's 3-way
        comparison (reference: scripts/evaluate_and_compare.py:129-134 gates
        the student at >= 95% of this number). O(Q x N) pair scorings:
        evaluation-scale corpora only."""
        doc_ids = list(corpus.keys())
        doc_texts = [corpus[d] for d in doc_ids]
        max_k = min(max(self.k_values), len(doc_ids))
        results: dict[str, list[float]] = {}
        total_relevant: dict[str, int] = {}
        for qid, qtext in queries.items():
            scores = np.asarray(
                teacher.score([(qtext, t) for t in doc_texts], batch_size=batch_size)
            )
            order = np.argsort(-scores)[:max_k]
            rels = qrels.get(qid, {})
            results[qid] = [float(rels.get(doc_ids[i], 0.0)) for i in order]
            total_relevant[qid] = sum(1 for v in rels.values() if v > 0)
        return compute_retrieval_metrics(results, total_relevant, ks=self.k_values)

    # ------------------------------------------------------------------

    def evaluate_retrieval_reranked(
        self,
        model,
        teacher,
        queries: Mapping[str, str],
        corpus: Mapping[str, str],
        qrels: Mapping[str, Mapping[str, float]],
        rerank_k: int = 10,
        batch_size: int = 256,
    ) -> dict[str, float]:
        """The serving rerank path, measured: the student retrieves
        ``rerank_k`` candidates, the cross-encoder re-orders them, and the
        reranked list is scored (the reference's "+rerank" row, reference
        docs/overview/results-and-benchmarks.md:42-48). O(Q x rerank_k) pair
        scorings, in one flat teacher call."""
        doc_ids = list(corpus.keys())
        doc_emb = model.encode_documents([corpus[d] for d in doc_ids], batch_size=self.batch_size)
        qids = list(queries.keys())
        q_emb = model.encode_queries([queries[q] for q in qids], batch_size=self.batch_size)
        fetch_k = min(rerank_k, len(doc_ids))
        _, top_idx = self._topk(q_emb, doc_emb, fetch_k)

        pairs = [(queries[qid], corpus[doc_ids[di]])
                 for qi, qid in enumerate(qids) for di in top_idx[qi] if di >= 0]
        flat_scores = np.asarray(teacher.score(pairs, batch_size=batch_size))

        results: dict[str, list[float]] = {}
        total_relevant: dict[str, int] = {}
        cursor = 0
        for qi, qid in enumerate(qids):
            cand = [di for di in top_idx[qi] if di >= 0]
            scores = flat_scores[cursor : cursor + len(cand)]
            cursor += len(cand)
            order = np.argsort(-scores)
            rels = qrels.get(qid, {})
            results[qid] = [float(rels.get(doc_ids[cand[i]], 0.0)) for i in order]
            total_relevant[qid] = sum(1 for v in rels.values() if v > 0)
        # the reranked list holds only rerank_k candidates: metrics at k >
        # rerank_k would be computed on a truncated list
        ks = [k for k in self.k_values if k <= rerank_k] or [rerank_k]
        return compute_retrieval_metrics(results, total_relevant, ks=ks)

    # ------------------------------------------------------------------

    def evaluate_ranking_quality(
        self,
        model,
        queries: Sequence[str],
        docs_per_query: Sequence[Sequence[str]],
        teacher_scores: Sequence[Sequence[float]],
        qrels_binary: Sequence[Sequence[int]] | None = None,
    ) -> dict[str, float]:
        """Agreement with the teacher: mean Kendall tau over queries, plus ECE
        of min-max normalized student scores against binary relevance when
        provided (reference: eval.py:103-175)."""
        taus = []
        all_conf: list[float] = []
        all_acc: list[float] = []
        for qi, (query, docs, t_scores) in enumerate(
            zip(queries, docs_per_query, teacher_scores)
        ):
            q = model.encode_queries([query])
            d = model.encode_documents(list(docs))
            s = (q @ d.T)[0]
            if len(docs) >= 2:
                taus.append(kendall_tau(s, np.asarray(t_scores)))
            lo, hi = float(s.min()), float(s.max())
            norm = (s - lo) / (hi - lo) if hi > lo else np.full_like(s, 0.5)
            if qrels_binary is not None:
                all_conf.extend(norm.tolist())
                all_acc.extend([float(x) for x in qrels_binary[qi]])
        out = {"kendall_tau": float(np.mean(taus)) if taus else 0.0}
        if all_conf:
            out["ece"] = expected_calibration_error(all_conf, all_acc)
        return out

    # ------------------------------------------------------------------

    def compare_models(
        self,
        models: Mapping[str, object],
        queries: Mapping[str, str],
        corpus: Mapping[str, str],
        qrels: Mapping[str, Mapping[str, float]],
        teacher_name: str = "teacher",
        acceptance_ratio: float = 0.95,
    ):
        """Evaluate each model and return (rows, gate_result): ``rows`` maps
        each name to its metrics. Gate: every non-teacher model passes iff
        its nDCG@10 >= 95% of the teacher's (reference:
        scripts/evaluate_and_compare.py:129-134); None without a teacher
        row."""
        rows = {}
        for name, model in models.items():
            rows[name] = self.evaluate_retrieval(model, queries, corpus, qrels)
            logger.info(f"{name}: ndcg@10={rows[name].get('ndcg@10', 0):.4f}")
        gate = None
        if teacher_name in rows:
            teacher_ndcg = rows[teacher_name].get("ndcg@10", 0.0)
            gate = {
                name: bool(metrics.get("ndcg@10", 0.0) >= acceptance_ratio * teacher_ndcg)
                for name, metrics in rows.items()
                if name != teacher_name
            }
        return rows, gate

    # ------------------------------------------------------------------

    @staticmethod
    def generate_report(results: Mapping[str, Mapping[str, float]],
                        title: str = "KD Evaluation") -> str:
        """Markdown comparison report (reference: eval.py:302-334)."""
        lines = [f"# {title}", ""]
        metric_names = sorted({m for row in results.values() for m in row})
        lines.append("| model | " + " | ".join(metric_names) + " |")
        lines.append("|---|" + "---|" * len(metric_names))
        for name, row in results.items():
            cells = [f"{row.get(m, float('nan')):.4f}" for m in metric_names]
            lines.append(f"| {name} | " + " | ".join(cells) + " |")
        lines.append("")
        return "\n".join(lines)
