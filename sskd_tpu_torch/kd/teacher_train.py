"""TeacherTrainer: pointwise relevance training of the cross-encoder (port of
sskd_tpu/kd/teacher_train.py).

:func:`triples_from_raw` builds (query, passage, label) triples from
MS-MARCO-shaped raw JSONL as the JAX package does (selected passages as
positives, the row's others, BM25-mined hard negatives, random and
cross-query-positive negatives), drawing from the same
``numpy.random.default_rng(seed)`` sequence, so the two packages give the
same triples.

:class:`TeacherTrainer` trains a :class:`~sskd_tpu_torch.models.teacher.
TeacherModel` in place on sigmoid binary cross-entropy, written as optax
writes it, with dropout live (the attention through ``dropout_attention``
and its kernels) and no remat. Batches are drawn from the JAX trainer's
``default_rng(seed)`` sequence (class-balanced by ``pos_fraction``), so both
pick the same rows. The optimizer is the KD trainer's
:class:`~sskd_tpu_torch.kd.train.KDOptimizer`: ``clip_by_global_norm`` and
AdamW on a linear warmup and decay, the first update at rate 0. Each step's
dropout masks come from ``seed`` and the step (the JAX trainer's
``rng_impl`` has no counterpart: the port has one generator); the losses
stay on the device until the end.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sskd_tpu_torch.config import TrainingConfig
from sskd_tpu_torch.exceptions import ConfigError, DataError
from sskd_tpu_torch.kd.train import KDOptimizer
from sskd_tpu_torch.parallel.tp import is_tensor_parallel
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("kd.teacher_train")

_SEED_STRIDE = 1_000_003  # step seed = seed * stride + step


def _iter_passages(row: dict):
    """(passage_text, is_selected) from either MS MARCO layout: the v2.1
    nested ``passages{passage_text[], is_selected[]}`` or a list of passage
    dicts (copy of sskd_tpu/data/prepare.py:41)."""
    passages = row.get("passages")
    if passages is None:
        return
    if isinstance(passages, dict):
        texts = passages.get("passage_text", [])
        selected = passages.get("is_selected", [0] * len(texts))
        for text, sel in zip(texts, selected):
            yield text, int(sel)
    elif isinstance(passages, list):
        for p in passages:
            yield p.get("passage_text", ""), int(p.get("is_selected", 0))
    else:
        raise DataError(f"unrecognized passages layout: {type(passages)}")


def triples_from_raw(
    raw_jsonl: str | Path,
    max_samples: int | None = None,
    random_negatives_per_query: int = 2,
    hard_negatives_per_query: int = 3,
    cross_positive_negatives_per_query: int = 3,
    seed: int = 0,
) -> list[tuple[str, str, float]]:
    """(query, passage, label) triples from MS-MARCO-shaped raw JSONL:
    ``is_selected == 1`` passages are positives, the row's others in-query
    negatives; then BM25's top passages that are not the query's positives
    (hard negatives), random passages from other rows, and other queries'
    positives, the whole list shuffled."""
    from sskd_tpu_torch.mining.bm25 import BM25Index

    rows: list[tuple[str, list[str], list[str]]] = []  # (query, pos, neg)
    all_passages: list[str] = []
    with open(raw_jsonl) as f:
        for line in f:
            if max_samples and len(rows) >= max_samples:
                break
            row = json.loads(line)
            pos, neg = [], []
            for text, selected in _iter_passages(row):
                (pos if selected == 1 else neg).append(text)
                all_passages.append(text)
            if pos:
                rows.append((row.get("query", ""), pos, neg))

    bm25 = None
    dedup_texts: list[str] = []
    if hard_negatives_per_query > 0:
        dedup_texts = list(dict.fromkeys(all_passages))
        bm25 = BM25Index().build(dedup_texts, [str(i) for i in range(len(dedup_texts))])

    rng = np.random.default_rng(seed)
    triples: list[tuple[str, str, float]] = []
    for query, pos, neg in rows:
        triples += [(query, text, 1.0) for text in pos]
        triples += [(query, text, 0.0) for text in neg]
        own = set(pos) | set(neg)
        if bm25 is not None:
            pos_set = set(pos)
            added = 0
            for doc_id, _ in bm25.search(query, k=hard_negatives_per_query + len(pos)):
                cand = dedup_texts[int(doc_id)]
                if cand in pos_set:
                    continue
                triples.append((query, cand, 0.0))
                added += 1
                if added >= hard_negatives_per_query:
                    break
        for _ in range(random_negatives_per_query):
            cand = all_passages[int(rng.integers(len(all_passages)))]
            if cand not in own:
                triples.append((query, cand, 0.0))
    # other queries' positives as negatives
    all_positives = list(dict.fromkeys(text for _, pos, _ in rows for text in pos))
    for query, pos, _ in rows:
        pos_set = set(pos)
        added = 0
        for j in rng.permutation(len(all_positives)):
            cand = all_positives[int(j)]
            if cand not in pos_set:
                triples.append((query, cand, 0.0))
                added += 1
                if added >= cross_positive_negatives_per_query:
                    break
    rng.shuffle(triples)
    return triples


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise, as ``optax.sigmoid_binary_cross_entropy`` writes it."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class TeacherTrainer:
    """Trains a :class:`~sskd_tpu_torch.models.teacher.TeacherModel` in place."""

    def __init__(
        self,
        teacher,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.01,
        warmup_ratio: float = 0.1,
        max_grad_norm: float = 1.0,
        seed: int = 0,
    ):
        if is_tensor_parallel(teacher.module):
            raise ConfigError("the teacher is tensor-parallel (shard_tensor_parallel), which is "
                              "for scoring: train it unsharded")
        self.teacher = teacher
        self.cfg = TrainingConfig(learning_rate=learning_rate, weight_decay=weight_decay,
                                  warmup_ratio=warmup_ratio, max_grad_norm=max_grad_norm)
        self.seed = seed
        self._opt: KDOptimizer | None = None

    def _tokenize(self, triples, max_len: int):
        batch = self.teacher.tokenizer.encode_batch(
            [q for q, _, _ in triples], text_pairs=[d for _, d, _ in triples],
            max_length=max_len, pad_to=max_len,
        )
        labels = np.asarray([lab for _, _, lab in triples], np.float32)
        return batch, labels

    def _train_step(self, ids, mask, types, labels, step: int) -> torch.Tensor:
        """One step on a batch already on the device: forward with dropout,
        the mean loss, backward, the optimizer. Returns the loss (a device
        scalar)."""
        self._opt.begin()
        logits = self.teacher.module(ids, mask, types,
                                     dropout_seed=self.seed * _SEED_STRIDE + step)
        loss = sigmoid_binary_cross_entropy(logits, labels).mean()
        loss.backward()
        self._opt.step()
        return loss.detach()

    def train(
        self,
        triples: Sequence[tuple[str, str, float]],
        steps: int = 300,
        batch_size: int = 32,
        max_len: int = 64,
        eval_frac: float = 0.1,
        pos_fraction: float = 0.25,
    ) -> dict:
        """``steps`` steps on batches of ``batch_size`` triples framed at
        ``max_len``, the first ``eval_frac`` of the triples held out for
        :meth:`pair_accuracy`. ``pos_fraction``: each batch draws
        ``round(batch_size * pos_fraction)`` positives with replacement
        (mined triples run about 1 positive to 8 negatives, and uniform
        batches collapse the pointwise objective toward predicting 0); 0
        draws uniformly."""
        module, dev = self.teacher.module, self.teacher.device
        n_eval = max(1, int(len(triples) * eval_frac))
        eval_triples = list(triples[:n_eval])
        train_triples = list(triples[n_eval:]) or list(triples)

        batch, labels = self._tokenize(train_triples, max_len)
        ids, mask, types = (torch.from_numpy(batch[k]).to(dev).long()
                            for k in ("input_ids", "attention_mask", "token_type_ids"))
        labels_t = torch.from_numpy(labels).to(dev)
        n = ids.shape[0]
        pos_idx = np.nonzero(labels > 0.5)[0]
        neg_idx = np.nonzero(labels <= 0.5)[0]
        n_pos = (int(round(batch_size * pos_fraction))
                 if 0 < pos_fraction < 1 and len(pos_idx) and len(neg_idx) else 0)

        self._opt = KDOptimizer(module.parameters(), self.cfg, steps)
        module.train()
        rng = np.random.default_rng(self.seed)
        losses = []
        try:
            for step in range(steps):
                if n_pos:
                    idx = np.concatenate([
                        pos_idx[rng.integers(0, len(pos_idx), n_pos)],
                        neg_idx[rng.integers(0, len(neg_idx), batch_size - n_pos)],
                    ])
                else:
                    idx = rng.integers(0, n, size=batch_size)
                at = torch.from_numpy(idx).to(dev)
                losses.append(self._train_step(ids[at], mask[at], types[at], labels_t[at], step))
                if (step + 1) % max(1, steps // 5) == 0:
                    logger.info(f"teacher step {step + 1}/{steps}: loss={float(losses[-1]):.4f}")
        finally:
            module.eval()
        losses = torch.stack(losses).cpu().tolist()
        acc = self.pair_accuracy(eval_triples)
        logger.info(f"teacher trained: final_loss={losses[-1]:.4f} "
                    f"heldout_pair_accuracy={acc:.3f}")
        return {
            "losses": losses,
            "final_loss": losses[-1],
            "heldout_pair_accuracy": acc,
            "steps": steps,
        }

    def pair_accuracy(self, triples: Sequence[tuple[str, str, float]]) -> float:
        """Share of (query, passage) pairs whose sigmoid(score) lands on the
        side of 0.5 that their label says."""
        if not triples:
            return 0.0
        scores = self.teacher.score([(q, d) for q, d, _ in triples])
        preds = [1.0 if s > 0 else 0.0 for s in scores]
        return float(np.mean([p == lab for p, (_, _, lab) in zip(preds, triples)]))
