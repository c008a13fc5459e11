"""KD training data packing (copy of sskd_tpu/kd/dataset.py, numpy only):
ragged (query, docs, teacher scores) samples -> fixed [B, N, L] padded
batches of numpy arrays with a ``doc_valid`` mask, so the train step is one
fully batched program.

Convention: ``docs[0]`` is the positive (the contrastive loss's column 0);
the remaining entries are negatives with their teacher scores as soft
labels. A short last batch is repeat-padded to the batch size and its padded
rows marked invalid. ``prefetch_batches`` packs batches in a producer thread
while the device runs.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

import numpy as np


@dataclass
class KDSample:
    query: str
    docs: list[str]  # docs[0] = positive
    teacher_scores: list[float]
    doc_ids: list[str] = field(default_factory=list)

    def __post_init__(self):
        if len(self.docs) != len(self.teacher_scores):
            raise ValueError("docs and teacher_scores must align")
        if not self.docs:
            raise ValueError("sample needs at least one doc")


class KDDataset:
    """Packs samples into padded batches for the train step."""

    def __init__(
        self,
        samples: Sequence[KDSample],
        tokenizer,
        num_docs: int = 8,
        query_len: int = 64,
        doc_len: int = 192,
        query_prefix: str = "query: ",
        passage_prefix: str = "passage: ",
    ):
        if not samples:
            raise ValueError("empty dataset")
        self.samples = list(samples)
        self.tokenizer = tokenizer
        self.num_docs = num_docs
        self.query_len = query_len
        self.doc_len = doc_len
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix

    def __len__(self) -> int:
        return len(self.samples)

    def _pack(self, batch: list[KDSample]) -> dict[str, np.ndarray]:
        B, N = len(batch), self.num_docs
        queries = [self.query_prefix + s.query for s in batch]
        q = self.tokenizer.encode_batch(queries, max_length=self.query_len)

        doc_texts: list[str] = []
        valid = np.zeros((B, N), np.float32)
        scores = np.zeros((B, N), np.float32)
        for bi, s in enumerate(batch):
            docs = s.docs[:N]
            for ni in range(N):
                if ni < len(docs):
                    doc_texts.append(self.passage_prefix + docs[ni])
                    valid[bi, ni] = 1.0
                    scores[bi, ni] = s.teacher_scores[ni]
                else:
                    doc_texts.append("")
        d = self.tokenizer.encode_batch(doc_texts, max_length=self.doc_len)
        return {
            "query_ids": q["input_ids"],
            "query_mask": q["attention_mask"],
            "doc_ids": d["input_ids"].reshape(B, N, self.doc_len),
            "doc_mask": d["attention_mask"].reshape(B, N, self.doc_len),
            "doc_valid": valid,
            "teacher_scores": scores,
        }

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        shard: tuple[int, int] = (0, 1),
    ) -> Iterator[dict[str, np.ndarray]]:
        """Batches of ``batch_size`` rows in a seeded shuffle. ``shard`` =
        (rank, world) packs only rows ``[rank * b, (rank + 1) * b)`` of each
        batch, b = batch_size / world: a data-parallel rank's share of the
        global batch, padding rows marked as they are in the whole batch."""
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"batch size {batch_size} is not a multiple of {world} shards")
        lo, hi = rank * batch_size // world, (rank + 1) * batch_size // world
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            n_real = len(idx)
            if n_real < batch_size:
                if drop_last:
                    return
                # repeat-pad to the static batch size; mark padded rows
                # invalid so they contribute nothing to the loss
                idx = np.concatenate([idx, order[: batch_size - n_real]])
            batch = self._pack([self.samples[i] for i in idx[lo:hi]])
            batch["doc_valid"][max(n_real - lo, 0):, :] = 0.0
            yield batch
            if n_real < batch_size:
                return

    def steps_per_epoch(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self.samples)
        return n // batch_size if drop_last else -(-n // batch_size)


_PREFETCH_END = object()


def prefetch_batches(
    batches: Iterable[dict[str, np.ndarray]], size: int = 2
) -> Iterator[dict[str, np.ndarray]]:
    """Overlap host-side batch packing with device compute.

    A daemon thread drains ``batches`` (tokenize + pad, host work) into a
    bounded queue while the train loop issues device work. ``size=0``
    degrades to plain synchronous iteration.

    Order is preserved exactly; producer exceptions re-raise in the
    consumer; abandoning the iterator (early break / GC) unblocks and
    stops the producer.
    """
    if size <= 0:
        yield from batches
        return
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    failure: list[BaseException] = []

    def _produce() -> None:
        try:
            for item in batches:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:  # surfaced to the consumer below
            failure.append(exc)
        finally:
            while not stop.is_set():
                try:
                    q.put(_PREFETCH_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    worker = threading.Thread(
        target=_produce, name="kd-batch-prefetch", daemon=True
    )
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _PREFETCH_END:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
