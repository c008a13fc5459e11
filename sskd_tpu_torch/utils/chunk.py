"""Sliding-window text chunking with exact character offsets (port of
sskd_tpu/utils/chunk.py).

``TextChunker`` cuts a text into windows of ``max_tokens`` tokens that
overlap by ``stride`` tokens, each with the character span it covers in the
source (reference: src/utils/chunk.py:9-120); the encoder sees at most 512
tokens, and a long document is split at preparation time.
``maxsim_aggregation`` / ``maxsim_aggregate_topk`` score a document by its
best chunk after a chunk-level top-k (the chunked evaluation), and
``compute_text_overlap`` is the character n-gram Jaccard overlap that
mining's denoising reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class Chunk:
    text: str
    start_char: int
    end_char: int
    num_tokens: int
    chunk_index: int

    def to_dict(self) -> dict:
        return {
            "text": self.text,
            "start_char": self.start_char,
            "end_char": self.end_char,
            "num_tokens": self.num_tokens,
            "chunk_index": self.chunk_index,
        }


class TextChunker:
    """Token-window chunker.

    ``tokenizer`` must expose ``tokenize_with_offsets(text) ->
    (token_ids, offsets)`` where offsets are ``(start_char, end_char)`` pairs
    (provided by :mod:`sskd_tpu_torch.tokenization`). Defaults match the training
    pipeline: 512-token windows with stride 80
    (reference: scripts/train_kd_pipeline.py:139-151, src/utils/chunk.py:30).
    """

    def __init__(
        self,
        tokenizer=None,
        max_tokens: int = 512,
        stride: int = 80,
    ):
        if max_tokens <= 0:
            raise ValueError("max_tokens must be positive")
        if stride < 0 or stride >= max_tokens:
            raise ValueError("stride must be in [0, max_tokens)")
        if tokenizer is None:
            from sskd_tpu_torch.tokenization import get_default_tokenizer

            tokenizer = get_default_tokenizer()
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.stride = stride

    def chunk_text(self, text: str) -> list[Chunk]:
        """Split ``text`` into overlapping windows of ``max_tokens`` tokens,
        stepping ``max_tokens - stride`` tokens each time. Character offsets
        are exact (reference: src/utils/chunk.py:30-99 via
        return_offsets_mapping)."""
        if not text or not text.strip():
            return []
        _, offsets = self.tokenizer.tokenize_with_offsets(text)
        n = len(offsets)
        if n == 0:
            return []
        if n <= self.max_tokens:
            return [
                Chunk(
                    text=text[offsets[0][0] : offsets[-1][1]],
                    start_char=offsets[0][0],
                    end_char=offsets[-1][1],
                    num_tokens=n,
                    chunk_index=0,
                )
            ]
        step = self.max_tokens - self.stride
        chunks: list[Chunk] = []
        start_tok = 0
        idx = 0
        while start_tok < n:
            end_tok = min(start_tok + self.max_tokens, n)
            start_char = offsets[start_tok][0]
            end_char = offsets[end_tok - 1][1]
            chunks.append(
                Chunk(
                    text=text[start_char:end_char],
                    start_char=start_char,
                    end_char=end_char,
                    num_tokens=end_tok - start_tok,
                    chunk_index=idx,
                )
            )
            idx += 1
            if end_tok == n:
                break
            start_tok += step
        return chunks

    def chunk_batch(self, texts: Sequence[str]) -> list[list[Chunk]]:
        return [self.chunk_text(t) for t in texts]


def maxsim_aggregation(
    chunk_scores: Sequence[float], chunk_doc_ids: Sequence[str]
) -> dict[str, float]:
    """Per-document max over chunk scores (reference: src/utils/chunk.py:123-147
    — dead code there, live here: applied after chunk-level top-k so a document
    is scored by its best chunk)."""
    out: dict[str, float] = {}
    for score, doc_id in zip(chunk_scores, chunk_doc_ids):
        score = float(score)
        if doc_id not in out or score > out[doc_id]:
            out[doc_id] = score
    return out


def maxsim_aggregate_topk(
    scores: np.ndarray, doc_ids: Sequence[str], k: int
) -> tuple[np.ndarray, list[str]]:
    """Vectorized MaxSim: collapse chunk-level (score, doc_id) pairs to
    doc-level best scores and return the top-k docs."""
    agg = maxsim_aggregation(np.asarray(scores).tolist(), list(doc_ids))
    items = sorted(agg.items(), key=lambda kv: -kv[1])[:k]
    if not items:
        return np.array([]), []
    top_ids = [d for d, _ in items]
    top_scores = np.array([s for _, s in items], dtype=np.float32)
    return top_scores, top_ids


def compute_text_overlap(text_a: str, text_b: str, n: int = 3) -> float:
    """Char n-gram Jaccard overlap (reference: src/utils/chunk.py:150-182).
    Used by mining denoising: negatives overlapping a positive above
    ``mining.denoise_text_overlap_threshold`` are dropped
    (reference: configs/kd.yaml:88-90 — intended but unwired there)."""
    a = text_a.lower()
    b = text_b.lower()
    if len(a) < n or len(b) < n:
        return 1.0 if a == b and a else 0.0
    grams_a = {a[i : i + n] for i in range(len(a) - n + 1)}
    grams_b = {b[i : i + n] for i in range(len(b) - n + 1)}
    union = grams_a | grams_b
    if not union:
        return 0.0
    return len(grams_a & grams_b) / len(union)
