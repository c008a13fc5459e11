"""IR evaluation metrics, host-side numpy (port of sskd_tpu/utils/metrics.py).

nDCG@k, MRR@k, recall@k, precision@k, expected calibration error, Kendall
tau (through scipy), the risk-coverage curve and the aggregate
``compute_retrieval_metrics`` (reference: src/utils/metrics.py:11-239).

``ndcg_at_k`` keeps the reference's variant: linear gain and an IDCG over the
retrieved labels only (reference: src/utils/metrics.py:27-37);
``ndcg_at_k_standard`` is the textbook one, exponential gain and an IDCG over
every relevant label of the query.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _dcg(labels: np.ndarray, exponential: bool = False) -> float:
    if labels.size == 0:
        return 0.0
    discounts = 1.0 / np.log2(np.arange(2, labels.size + 2))
    gains = np.power(2.0, labels) - 1.0 if exponential else labels
    return float(np.sum(gains * discounts))


def ndcg_at_k(relevances: Sequence[float], k: int = 10) -> float:
    """nDCG@k matching the reference exactly: LINEAR gain (rel / log2) and
    IDCG over the retrieved labels only (reference: src/utils/metrics.py:27-37).
    ``relevances`` are the graded labels of the retrieved docs in rank order.
    Identical to the exponential-gain variant for binary labels; for graded
    labels use ``ndcg_at_k_standard`` for the TREC-style number."""
    rel = np.asarray(relevances, dtype=np.float64)[:k]
    dcg = _dcg(rel)
    ideal = _dcg(np.sort(rel)[::-1])
    if ideal == 0.0:
        return 0.0
    return dcg / ideal


def ndcg_at_k_standard(
    relevances: Sequence[float], all_relevances: Sequence[float], k: int = 10
) -> float:
    """Textbook/TREC nDCG@k: exponential gain (2^rel - 1) and IDCG from the
    global ideal ranking over ``all_relevances`` (every relevant label for the
    query, retrieved or not) — the two deliberate divergences from the
    reference's variant, reported alongside it (SURVEY.md section 7.4)."""
    rel = np.asarray(relevances, dtype=np.float64)[:k]
    ideal_pool = np.sort(np.asarray(all_relevances, dtype=np.float64))[::-1][:k]
    dcg = _dcg(rel, exponential=True)
    ideal = _dcg(ideal_pool, exponential=True)
    if ideal == 0.0:
        return 0.0
    return dcg / ideal


def mrr_at_k(relevances: Sequence[float], k: int = 10) -> float:
    """Mean reciprocal rank of the first relevant result
    (reference: src/utils/metrics.py:40-55)."""
    rel = np.asarray(relevances, dtype=np.float64)[:k]
    hits = np.nonzero(rel > 0)[0]
    if hits.size == 0:
        return 0.0
    return 1.0 / float(hits[0] + 1)


def recall_at_k(
    relevances: Sequence[float], total_relevant: int, k: int = 10
) -> float:
    """Fraction of all relevant docs retrieved in the top k
    (reference: src/utils/metrics.py:58-75)."""
    if total_relevant <= 0:
        return 0.0
    rel = np.asarray(relevances, dtype=np.float64)[:k]
    return float(np.sum(rel > 0)) / float(total_relevant)


def precision_at_k(relevances: Sequence[float], k: int = 10) -> float:
    """Fraction of the top k that is relevant
    (reference: src/utils/metrics.py:78-95)."""
    if k <= 0:
        return 0.0
    rel = np.asarray(relevances, dtype=np.float64)[:k]
    if rel.size == 0:
        return 0.0
    return float(np.sum(rel > 0)) / float(k)


def expected_calibration_error(
    confidences: Sequence[float], accuracies: Sequence[float], n_bins: int = 10
) -> float:
    """ECE over equal-width confidence bins
    (reference: src/utils/metrics.py:98-128)."""
    conf = np.asarray(confidences, dtype=np.float64)
    acc = np.asarray(accuracies, dtype=np.float64)
    if conf.size == 0:
        return 0.0
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(bins[:-1], bins[1:]):
        mask = (conf > lo) & (conf <= hi) if lo > 0 else (conf >= lo) & (conf <= hi)
        if not np.any(mask):
            continue
        weight = float(np.mean(mask))
        ece += weight * abs(float(np.mean(acc[mask])) - float(np.mean(conf[mask])))
    return float(ece)


def kendall_tau(scores_a: Sequence[float], scores_b: Sequence[float]) -> float:
    """Kendall rank correlation between two score lists
    (reference: src/utils/metrics.py:131-157, via scipy)."""
    from scipy.stats import kendalltau

    a = np.asarray(scores_a, dtype=np.float64)
    b = np.asarray(scores_b, dtype=np.float64)
    if a.size < 2 or b.size < 2:
        return 0.0
    tau, _ = kendalltau(a, b)
    if np.isnan(tau):
        return 0.0
    return float(tau)


def risk_coverage_curve(
    confidences: Sequence[float], correctness: Sequence[float]
) -> tuple[np.ndarray, np.ndarray]:
    """Risk (error rate) vs coverage when abstaining below a confidence
    threshold, sorted by descending confidence
    (reference: src/utils/metrics.py:160-193)."""
    conf = np.asarray(confidences, dtype=np.float64)
    correct = np.asarray(correctness, dtype=np.float64)
    if conf.size == 0:
        return np.array([]), np.array([])
    order = np.argsort(-conf)
    correct_sorted = correct[order]
    n = conf.size
    coverage = np.arange(1, n + 1) / n
    cum_errors = np.cumsum(1.0 - correct_sorted)
    risk = cum_errors / np.arange(1, n + 1)
    return coverage, risk


def compute_retrieval_metrics(
    results: dict[str, list[float]],
    total_relevant: dict[str, int] | None = None,
    ks: Sequence[int] = (1, 5, 10, 20),
) -> dict[str, float]:
    """Aggregate per-query metrics into means
    (reference: src/utils/metrics.py:196-239).

    ``results`` maps query_id -> relevance labels of retrieved docs in rank
    order. ``total_relevant`` maps query_id -> number of relevant docs
    (defaults to count of positive labels among retrieved).
    """
    out: dict[str, float] = {}
    if not results:
        return out
    qids = list(results.keys())
    for k in ks:
        out[f"ndcg@{k}"] = float(
            np.mean([ndcg_at_k(results[q], k) for q in qids])
        )
        out[f"mrr@{k}"] = float(np.mean([mrr_at_k(results[q], k) for q in qids]))
        out[f"precision@{k}"] = float(
            np.mean([precision_at_k(results[q], k) for q in qids])
        )
        recalls = []
        for q in qids:
            total = (
                total_relevant[q]
                if total_relevant is not None and q in total_relevant
                else int(np.sum(np.asarray(results[q]) > 0))
            )
            recalls.append(recall_at_k(results[q], total, k))
        out[f"recall@{k}"] = float(np.mean(recalls))
    return out
