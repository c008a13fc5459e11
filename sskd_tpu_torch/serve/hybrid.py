"""Hybrid lexical + semantic retrieval (port of sskd_tpu/serve/hybrid.py).

- Reciprocal-rank fusion (``rrf``): ``score(d) = sum over arms of
  w / (rrf_k + rank(d))``, ranks from 1; a document missing from an arm
  gets nothing from it.
- Linear fusion (``linear``): each arm's scores min-max normalized to
  [0, 1], then the weighted sum.
- RM3-lite query expansion: the best tf x idf terms of the top BM25 hits,
  not already in the query, appended to the lexical arm's query only.

Host-side list arithmetic on the candidates (tens to hundreds), over the
port's BM25 index (``mining/bm25.py``); ties break by doc id, as in the JAX
package, so both give the same order.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

from sskd_tpu_torch.mining.bm25 import BM25Index, tokenize

Ranked = Sequence[tuple[str, float]]  # (doc_id, score) in rank order


def rrf_fuse(
    arms: Sequence[Ranked], weights: Sequence[float], rrf_k: int = 60, k: int = 10
) -> list[tuple[str, float]]:
    """Weighted reciprocal-rank fusion of ranked lists."""
    if len(arms) != len(weights):
        raise ValueError("arms and weights must align")
    fused: dict[str, float] = {}
    for arm, w in zip(arms, weights):
        for rank, (doc_id, _score) in enumerate(arm, start=1):
            fused[doc_id] = fused.get(doc_id, 0.0) + w / (rrf_k + rank)
    return sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def _minmax(scores: Sequence[float]) -> list[float]:
    if not scores:
        return []
    lo, hi = min(scores), max(scores)
    if hi - lo < 1e-12:
        return [1.0] * len(scores)
    return [(s - lo) / (hi - lo) for s in scores]


def linear_fuse(
    arms: Sequence[Ranked], weights: Sequence[float], k: int = 10
) -> list[tuple[str, float]]:
    """Min-max-normalized weighted sum of scored lists."""
    if len(arms) != len(weights):
        raise ValueError("arms and weights must align")
    fused: dict[str, float] = {}
    for arm, w in zip(arms, weights):
        for (doc_id, _), ns in zip(arm, _minmax([s for _, s in arm])):
            fused[doc_id] = fused.get(doc_id, 0.0) + w * ns
    return sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def expand_query(query: str, bm25: BM25Index, n_docs: int = 3, n_terms: int = 5) -> str:
    """The query with the ``n_terms`` best tf x idf terms of its top
    ``n_docs`` BM25 hits (those with a score above 0) appended; the query
    unchanged when there are none."""
    hits = [(d, s) for d, s in bm25.search(query, k=n_docs) if s > 0.0]
    if not hits:
        return query
    q_terms = set(tokenize(query))
    tf: Counter[str] = Counter()
    pos_by_id = {d: i for i, d in enumerate(bm25.doc_ids)}
    for doc_id, _ in hits:
        idx = pos_by_id.get(doc_id)
        if idx is not None:
            tf.update(t for t in bm25.tokenized_corpus[idx] if t not in q_terms)
    if not tf:
        return query
    scored = []
    for term, count in tf.items():
        ti = bm25._vocab.get(term)
        scored.append((count * (float(bm25._idf[ti]) if ti is not None else 0.0), term))
    scored.sort(key=lambda x: (-x[0], x[1]))
    extra = [t for _, t in scored[:n_terms]]
    return query + " " + " ".join(extra) if extra else query


class HybridSearcher:
    """Fuses the dense engine's candidates with a BM25 arm over the same
    corpus; built once at startup, ``fuse`` called per request."""

    def __init__(
        self,
        bm25: BM25Index,
        bm25_weight: float = 0.3,
        semantic_weight: float = 0.7,
        fusion_method: str = "rrf",
        rrf_k: int = 60,
        query_expansion: bool = False,
        expansion_docs: int = 3,
        expansion_terms: int = 5,
    ):
        if fusion_method not in ("rrf", "linear"):
            raise ValueError(f"unknown fusion_method {fusion_method!r}")
        self.bm25 = bm25
        self.bm25_weight = bm25_weight
        self.semantic_weight = semantic_weight
        self.fusion_method = fusion_method
        self.rrf_k = rrf_k
        self.query_expansion = query_expansion
        self.expansion_docs = expansion_docs
        self.expansion_terms = expansion_terms

    def lexical_arm(self, query: str, k: int) -> list[tuple[str, float]]:
        if self.query_expansion:
            query = expand_query(query, self.bm25, self.expansion_docs, self.expansion_terms)
        return self.bm25.search(query, k=k)

    def fuse(self, query: str, dense: Ranked, k: int) -> list[tuple[str, float]]:
        """The top ``k`` (doc_id, fused score); the lexical arm fetches as
        many candidates as the dense arm gave, so both have equal depth."""
        lexical = self.lexical_arm(query, k=max(k, len(dense)))
        arms = [list(dense), lexical]
        weights = [self.semantic_weight, self.bm25_weight]
        if self.fusion_method == "rrf":
            return rrf_fuse(arms, weights, rrf_k=self.rrf_k, k=k)
        return linear_fuse(arms, weights, k=k)
