"""Hard-negative mining: 3-stage curriculum BM25 -> teacher rescoring -> ANCE
(port of sskd_tpu/mining/miners.py).

Re-implements the reference miners (reference: src/mining/miners.py:22-335,
docs/decisions/adr-003) with two upgrades the reference configured but never
wired:

- denoising: negatives whose char-3-gram overlap with any positive exceeds
  ``denoise_threshold`` are dropped (reference: configs/kd.yaml:88-90 via
  the dead ``compute_text_overlap``, live here);
- ANCE refresh: :class:`ANCEMiner` re-encodes with the *current* student, so
  the trainer can refresh negatives every N steps
  (reference: configs/kd.yaml:100 ``ance_refresh_every_n_steps``).

Stage semantics match the reference exactly
(reference: miners.py:256-335):
  stage 1 — BM25 top-k (100) with 0.0 placeholder scores;
  stage 2 — BM25 candidates rescored by the teacher, keep top-k (10) with
            confidence >= 0.6, teacher scores become soft labels;
  stage 3 — BM25 -> teacher top-20 -> ANCE top-5 student-adversarial picks,
            combined = union(teacher top-5, ANCE picks), ANCE-only entries
            padded with 0.0 scores.

Selection follows the JAX package step for step, so ties break the same way.
The teacher scores all pairs in one call (on its own device); ANCE's
query-document products run as one f32 product on the student's device
(``student.device``; the CPU for a student without one).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

import torch

from sskd_tpu_torch.utils.chunk import compute_text_overlap
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("mining")


@dataclass
class MinedNegatives:
    """Per-query mining result: ids aligned with scores."""

    doc_ids: list[str] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)


def _denoise(
    candidate_ids: list[str],
    corpus: Mapping[str, str],
    positive_texts: Sequence[str],
    threshold: float,
) -> list[str]:
    """Drop candidates that are near-duplicates of a positive (false
    negatives). threshold >= 1.0 disables."""
    if threshold >= 1.0 or not positive_texts:
        return candidate_ids
    kept = []
    for cid in candidate_ids:
        text = corpus.get(cid, "")
        if all(compute_text_overlap(text, p) < threshold for p in positive_texts):
            kept.append(cid)
    return kept


class BM25Miner:
    """Stage 1: lexical candidates, positives excluded
    (reference: miners.py:22-78)."""

    def __init__(self, bm25, top_k: int = 100):
        self.bm25 = bm25
        self.top_k = top_k

    def mine(
        self,
        queries: Sequence[str],
        positives_per_query: Sequence[Sequence[str]],
    ) -> list[MinedNegatives]:
        out = []
        for query, positives in zip(queries, positives_per_query):
            pos = set(positives)
            # over-fetch so exclusions don't shrink the pool
            hits = self.bm25.search(query, k=self.top_k + len(pos))
            ids = [d for d, _ in hits if d not in pos][: self.top_k]
            out.append(MinedNegatives(doc_ids=ids, scores=[0.0] * len(ids)))
        return out


class TeacherMiner:
    """Stage 2: cross-encoder rescoring with a confidence floor
    (reference: miners.py:81-158)."""

    def __init__(
        self,
        teacher,
        batch_size: int = 32,
        top_k: int = 10,
        confidence_threshold: float = 0.6,
    ):
        self.teacher = teacher
        self.batch_size = batch_size
        self.top_k = top_k
        self.confidence_threshold = confidence_threshold

    def mine(
        self,
        queries: Sequence[str],
        candidates_per_query: Sequence[Sequence[str]],
        corpus: Mapping[str, str],
    ) -> list[MinedNegatives]:
        # ONE global cross-query score call: the reference issued a separate
        # cross-encoder dispatch per query (reference: miners.py:100-137 —
        # O(queries) tiny device round-trips); flattening all pairs lets the
        # teacher fill full device batches regardless of per-query candidate
        # counts. Per-query selection below is unchanged, so results are
        # pinned equal to the per-query path (tests/test_bm25_mining.py).
        kept_ids: list[list[str]] = []
        all_pairs: list[tuple[str, str]] = []
        for query, cand_ids in zip(queries, candidates_per_query):
            ids = [c for c in cand_ids if c in corpus]
            kept_ids.append(ids)
            all_pairs.extend((query, corpus[c]) for c in ids)
        if not all_pairs:
            return [MinedNegatives() for _ in kept_ids]
        all_scores = np.asarray(
            self.teacher.score(all_pairs, batch_size=self.batch_size)
        )

        out = []
        offset = 0
        for cand_ids in kept_ids:
            if not cand_ids:
                out.append(MinedNegatives())
                continue
            scores = all_scores[offset : offset + len(cand_ids)]
            offset += len(cand_ids)
            order = np.argsort(-scores)
            ids, kept_scores = [], []
            for i in order:
                if len(ids) >= self.top_k:
                    break
                if self.teacher.get_confidence(scores[i]) >= self.confidence_threshold:
                    ids.append(cand_ids[i])
                    kept_scores.append(float(scores[i]))
            out.append(MinedNegatives(doc_ids=ids, scores=kept_scores))
        return out


class ANCEMiner:
    """Stage 3: student-adversarial negatives — candidates the CURRENT
    student scores within ``margin`` of its best positive
    (reference: miners.py:161-253)."""

    def __init__(self, student, margin: float = 0.1, top_k: int = 5):
        self.student = student
        self.margin = margin
        self.top_k = top_k

    def mine(
        self,
        queries: Sequence[str],
        positives_per_query: Sequence[Sequence[str]],
        candidates_per_query: Sequence[Sequence[str]],
        corpus: Mapping[str, str],
    ) -> list[MinedNegatives]:
        # ONE encode call for all queries and ONE for all unique texts
        # (positives + candidates): the reference encoded per query — three
        # tiny device dispatches each (reference: miners.py:161-253); a
        # global deduplicated batch fills the encoder and never re-encodes a
        # text shared across queries. Selection math per query is unchanged.
        live = [
            (qi, [c for c in cand_ids if c in corpus])
            for qi, cand_ids in enumerate(candidates_per_query)
        ]
        active = [
            qi
            for qi, ids in live
            if ids and positives_per_query[qi]
        ]
        out = [MinedNegatives() for _ in queries]
        if not active:
            return out

        uniq: dict[str, int] = {}
        for qi in active:
            for text in positives_per_query[qi]:
                uniq.setdefault(text, len(uniq))
            for cid in live[qi][1]:
                uniq.setdefault(corpus[cid], len(uniq))
        texts = list(uniq)
        q_emb = self.student.encode_queries([queries[qi] for qi in active])
        d_emb = self.student.encode_documents(texts)
        # every query against every text at once, on the student's device
        device = getattr(self.student, "device", None) or "cpu"
        sims = (torch.as_tensor(np.asarray(q_emb, np.float32), device=device)
                @ torch.as_tensor(np.asarray(d_emb, np.float32), device=device).T)
        sims = sims.cpu().numpy()

        for row, qi in enumerate(active):
            pos_rows = [uniq[t] for t in positives_per_query[qi]]
            cand_ids = live[qi][1]
            cand_rows = [uniq[corpus[c]] for c in cand_ids]
            max_pos = float(sims[row, pos_rows].max())
            cand_scores = sims[row, cand_rows]
            eligible = [
                (float(s), c)
                for s, c in zip(cand_scores, cand_ids)
                if s >= max_pos - self.margin
            ]
            eligible.sort(key=lambda t: -t[0])
            picked = eligible[: self.top_k]
            out[qi] = MinedNegatives(
                doc_ids=[c for _, c in picked],
                scores=[s for s, _ in picked],
            )
        return out


def build_mining_curriculum(
    stage: int,
    queries: Sequence[str],
    positives_per_query: Sequence[Sequence[str]],
    corpus: Mapping[str, str],
    bm25,
    teacher=None,
    student=None,
    positive_ids_per_query: Sequence[Sequence[str]] | None = None,
    bm25_top_k: int = 100,
    teacher_top_k: int = 10,
    teacher_confidence_threshold: float = 0.6,
    ance_top_k: int = 5,
    ance_margin: float = 0.1,
    teacher_batch_size: int = 32,
    denoise_threshold: float = 1.0,
) -> list[MinedNegatives]:
    """Stage dispatch (reference: miners.py:256-335). ``positives_per_query``
    holds positive *texts* (used by ANCE and denoising);
    ``positive_ids_per_query`` holds their corpus ids (used for BM25
    exclusion — defaults to empty, in which case only denoising can drop
    positives from the candidate pool)."""
    if stage not in (1, 2, 3):
        raise ValueError(f"stage must be 1..3, got {stage}")
    if positive_ids_per_query is None:
        positive_ids_per_query = [[] for _ in queries]

    bm25_miner = BM25Miner(bm25, top_k=bm25_top_k)
    bm25_out = bm25_miner.mine(queries, positive_ids_per_query)
    candidates = [
        _denoise(m.doc_ids, corpus, pos, denoise_threshold)
        for m, pos in zip(bm25_out, positives_per_query)
    ]
    if stage == 1:
        return [
            MinedNegatives(doc_ids=ids, scores=[0.0] * len(ids)) for ids in candidates
        ]

    if teacher is None:
        raise ValueError("stage >= 2 requires a teacher")
    # stage 3 rescoring keeps a deeper pool for ANCE to pick from
    # (reference: miners.py:300-332 — teacher top-20 feeding ANCE top-5)
    rescore_k = teacher_top_k if stage == 2 else max(teacher_top_k, 20)
    teacher_miner = TeacherMiner(
        teacher,
        batch_size=teacher_batch_size,
        top_k=rescore_k,
        confidence_threshold=teacher_confidence_threshold,
    )
    teacher_out = teacher_miner.mine(queries, candidates, corpus)
    if stage == 2:
        return teacher_out

    if student is None:
        raise ValueError("stage 3 requires a student")
    return refresh_ance_negatives(
        student,
        queries,
        positives_per_query,
        teacher_out,
        corpus,
        ance_top_k=ance_top_k,
        ance_margin=ance_margin,
    )


def refresh_ance_negatives(
    student,
    queries: Sequence[str],
    positives_per_query: Sequence[Sequence[str]],
    teacher_out: Sequence[MinedNegatives],
    corpus: Mapping[str, str],
    ance_top_k: int = 5,
    ance_margin: float = 0.1,
) -> list[MinedNegatives]:
    """Stage-3 union using cached teacher rescoring results — also the
    in-training ANCE refresh path (reference: configs/kd.yaml:100
    ``ance_refresh_every_n_steps``): the teacher pass is cached, only the
    student-adversarial selection reruns with the CURRENT student."""
    ance = ANCEMiner(student, margin=ance_margin, top_k=ance_top_k)
    ance_out = ance.mine(
        queries,
        positives_per_query,
        [m.doc_ids for m in teacher_out],
        corpus,
    )
    combined: list[MinedNegatives] = []
    for t_res, a_res in zip(teacher_out, ance_out):
        merged_ids: list[str] = []
        merged_scores: list[float] = []
        teacher_lookup = dict(zip(t_res.doc_ids, t_res.scores))
        # union(teacher top-5, ANCE picks); ANCE-only ids get 0.0 scores
        # (reference: miners.py:300-332)
        for cid in t_res.doc_ids[:5]:
            merged_ids.append(cid)
            merged_scores.append(teacher_lookup[cid])
        for cid in a_res.doc_ids:
            if cid not in merged_ids:
                merged_ids.append(cid)
                merged_scores.append(teacher_lookup.get(cid, 0.0))
        combined.append(MinedNegatives(doc_ids=merged_ids, scores=merged_scores))
    return combined
