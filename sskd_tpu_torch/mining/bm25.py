"""BM25 lexical index (port of sskd_tpu/mining/bm25.py).

Okapi BM25 with the JAX package's parameters (k1 1.5, b 0.75, epsilon 0.25,
a negative IDF replaced by epsilon times the average IDF) over lowercase
whitespace tokens. A query touches only its terms' postings: each term keeps
the documents that hold it and its counts there (numpy arrays, where the JAX
package keeps the columns of a scipy CSC matrix), and the scores take the
same f64 operations in the same order, so they equal the JAX package's bit
for bit, and so do ``search``'s ties.

Persistence is the JAX package's: four JSON files (doc ids, tokenized
corpus, parameters, a SHA-256 checksum of the first two), checked on load.
``build_from_parquet`` reads a chunk file through the port's own parquet
reader (``data/parquet.py``; the machine with the GPU has no pandas).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Sequence

import numpy as np

from sskd_tpu_torch.exceptions import ChecksumMismatchError, DataError
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("mining.bm25")


def tokenize(text: str) -> list[str]:
    """Lowercase whitespace tokenization."""
    return text.lower().split()


class BM25Index:
    K1_DEFAULT = 1.5
    B_DEFAULT = 0.75
    EPSILON_DEFAULT = 0.25

    def __init__(self, k1: float = K1_DEFAULT, b: float = B_DEFAULT,
                 epsilon: float = EPSILON_DEFAULT):
        self.k1 = k1
        self.b = b
        self.epsilon = epsilon
        self.doc_ids: list[str] = []
        self.tokenized_corpus: list[list[str]] = []
        self._built = False

    @property
    def ntotal(self) -> int:
        return len(self.doc_ids)

    def build(self, texts: Sequence[str], doc_ids: Sequence[str]) -> "BM25Index":
        if len(texts) != len(doc_ids):
            raise DataError("texts and doc_ids must align")
        self.doc_ids = [str(d) for d in doc_ids]
        self.tokenized_corpus = [tokenize(t) for t in texts]
        self._fit()
        return self

    def build_from_parquet(
        self,
        parquet_path: str | Path,
        text_column: str = "text",
        id_column: str = "chunk_id",
        max_docs: int | None = None,
    ) -> "BM25Index":
        from sskd_tpu_torch.data.parquet import read_parquet

        cols = read_parquet(parquet_path, columns=[id_column, text_column])
        ids, texts = cols[id_column], cols[text_column]
        if max_docs:
            ids, texts = ids[:max_docs], texts[:max_docs]
        return self.build(texts, [str(i) for i in ids])

    def _fit(self) -> None:
        n_docs = len(self.tokenized_corpus)
        if n_docs == 0:
            raise DataError("empty corpus")
        vocab: dict[str, int] = {}
        rows, cols, data = [], [], []
        doc_lens = np.zeros(n_docs, np.float64)
        for di, toks in enumerate(self.tokenized_corpus):
            doc_lens[di] = len(toks)
            counts: dict[int, int] = {}
            for t in toks:
                ti = vocab.setdefault(t, len(vocab))
                counts[ti] = counts.get(ti, 0) + 1
            for ti, c in counts.items():
                rows.append(di)
                cols.append(ti)
                data.append(c)
        n_terms = len(vocab)
        self._vocab = vocab
        # postings: the (document, count) pairs of each term, by term
        cols_arr = np.asarray(cols, np.int64)
        order = np.argsort(cols_arr, kind="stable")
        self._post_docs = np.asarray(rows, np.int64)[order]
        self._post_tf = np.asarray(data, np.float64)[order]
        self._post_start = np.searchsorted(cols_arr[order], np.arange(n_terms + 1))
        self._avgdl = float(doc_lens.mean()) if doc_lens.size else 0.0
        # Okapi IDF with the epsilon fixup: a negative idf -> epsilon * average idf
        df_arr = np.diff(self._post_start).astype(np.float64)
        idf = np.log(n_docs - df_arr + 0.5) - np.log(df_arr + 0.5)
        avg_idf = float(idf.mean()) if idf.size else 0.0
        self._idf = np.where(idf < 0, self.epsilon * avg_idf, idf)
        # the per-document length normalization of the denominator
        self._norm = self.k1 * (1.0 - self.b + self.b * doc_lens / max(self._avgdl, 1e-9))
        self._built = True
        logger.info(f"bm25 fit: docs={n_docs} vocab={n_terms} avgdl={self._avgdl:.1f}")

    def get_scores(self, query: str) -> np.ndarray:
        """BM25 scores (f64) of every document for ``query``."""
        if not self._built:
            raise DataError("index not built")
        scores = np.zeros(self.ntotal, np.float64)
        for term in tokenize(query):
            ti = self._vocab.get(term)
            if ti is None:
                continue
            a, b = self._post_start[ti], self._post_start[ti + 1]
            docs, tf = self._post_docs[a:b], self._post_tf[a:b]
            scores[docs] += self._idf[ti] * tf * (self.k1 + 1.0) / (tf + self._norm[docs])
        return scores

    def search(self, query: str, k: int = 10) -> list[tuple[str, float]]:
        scores = self.get_scores(query)
        k = min(k, self.ntotal)
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        return [(self.doc_ids[i], float(scores[i])) for i in top]

    def batch_search(self, queries: Sequence[str], k: int = 10) -> list[list[tuple[str, float]]]:
        return [self.search(q, k) for q in queries]

    def get_doc_text(self, doc_id: str) -> str:
        """The document's text as its tokens joined by spaces (lowercased,
        whitespace collapsed), as the JAX package rebuilds it."""
        try:
            idx = self.doc_ids.index(doc_id)
        except ValueError:
            raise DataError(f"unknown doc_id {doc_id!r}")
        return " ".join(self.tokenized_corpus[idx])

    @staticmethod
    def _checksum(doc_ids: list[str], corpus: list[list[str]]) -> str:
        h = hashlib.sha256()
        h.update(json.dumps(doc_ids).encode())
        h.update(json.dumps(corpus).encode())
        return h.hexdigest()

    def save(self, output_dir: str | Path) -> Path:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "doc_ids.json", "w") as f:
            json.dump(self.doc_ids, f)
        with open(out / "tokenized_corpus.json", "w") as f:
            json.dump(self.tokenized_corpus, f)
        with open(out / "bm25_params.json", "w") as f:
            json.dump({"k1": self.k1, "b": self.b, "epsilon": self.epsilon}, f)
        with open(out / "checksum.json", "w") as f:
            json.dump({"sha256": self._checksum(self.doc_ids, self.tokenized_corpus)}, f)
        return out

    @classmethod
    def load(cls, index_dir: str | Path) -> "BM25Index":
        path = Path(index_dir)
        with open(path / "doc_ids.json") as f:
            doc_ids = json.load(f)
        with open(path / "tokenized_corpus.json") as f:
            corpus = json.load(f)
        with open(path / "bm25_params.json") as f:
            params = json.load(f)
        with open(path / "checksum.json") as f:
            expected = json.load(f)["sha256"]
        actual = cls._checksum(doc_ids, corpus)
        if actual != expected:
            raise ChecksumMismatchError(
                "bm25 index corrupted: checksum mismatch",
                details={"expected": expected, "actual": actual},
            )
        idx = cls(**params)
        idx.doc_ids = doc_ids
        idx.tokenized_corpus = corpus
        idx._fit()
        return idx

    @staticmethod
    def exists(index_dir: str | Path) -> bool:
        """All four persistence files present (the pipeline's reuse check)."""
        path = Path(index_dir)
        return all(
            (path / name).exists()
            for name in ("doc_ids.json", "tokenized_corpus.json", "bm25_params.json",
                         "checksum.json")
        )


def build_bm25_index(
    parquet_path: str | Path,
    output_dir: str | Path,
    text_column: str = "text",
    id_column: str = "chunk_id",
    max_docs: int | None = None,
) -> BM25Index:
    """Build over a chunk file and persist (reference: bm25.py:239-283)."""
    idx = BM25Index().build_from_parquet(
        parquet_path, text_column=text_column, id_column=id_column, max_docs=max_docs
    )
    idx.save(output_dir)
    return idx
