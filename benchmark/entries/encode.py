"""The corpus encode of an index build: ``StudentModel.encode_documents``
over passages in corpus order, at the batch an index build uses.

Set-up draws the student's weights on the device, draws the corpus, and
encodes one batch that reaches each length bucket the traffic can reach. The
window then encodes call after call, each ``call_passages`` passages taken
in corpus order, and closes at the end of the first call that ends past the
run's seconds. Afterwards a sample of the encoded passages, drawn from the
seed and holding the longest, is encoded again by the plain reference in
float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import texts
from benchmark.harness.program import (bert_config, forward_describe, prefix_tokens, sample,
                                       tokenizer, warm_lengths)
from benchmark.harness.weights import draw_tree, sub_seed
from benchmark.reference.bert import arch_from_config, embed


class Entry:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.arch = arch_from_config(self.cfg)
        self.max_len = int(self.tr["max_seq_length"])
        self.attempted = self.failed = 0
        self.tokens = 0

    def setup(self) -> None:
        from sskd_tpu_torch.models.student import StudentModel

        run, tr = self.run, self.tr
        rng = np.random.default_rng(sub_seed(run.seed, 3))
        per = int(tr["call_passages"])
        lens = texts.lengths(tr["passage_tokens"], per, rng, int(tr["passage_pool"]) // per)
        self.passages = texts.texts(lens, rng)
        self.student = StudentModel(self.cfg["source"], device=run.device,
                                    config=bert_config(self.cfg),
                                    params=draw_tree(self.arch, run.seed, run.device),
                                    max_seq_length=self.max_len)
        self.prefix = self.student.passage_prefix
        self.real = np.minimum(2 + prefix_tokens(self.prefix) + lens, self.max_len)
        self.emb = np.zeros((len(self.passages), self.arch.hidden), np.float32)
        self.seen = np.zeros(len(self.passages), bool)
        self._warm()
        rec = run.recorder
        rec.wrap(self.student, "tokenize_batch", "tokenize")
        rec.wrap(self.student, "forward_batch", "forward", forward_describe)

    def _warm(self) -> None:
        """One batch at each length bucket that a batch of the traffic can
        reach."""
        pre = prefix_tokens(self.prefix)
        words = texts.words()
        batch = int(self.tr["batch_size"])
        for n in warm_lengths(self.real, batch, self.max_len, self.run.device):
            doc = " ".join(words[i % len(words)] for i in range(max(1, n - 2 - pre)))
            self.student.encode_documents([doc] * batch, batch_size=batch)

    def window(self) -> None:
        run, tr = self.run, self.tr
        per_call = int(tr["call_passages"])
        n = len(self.passages)
        start = 0
        run.open_window()
        while True:
            run.tracer.boundary()
            idx = np.arange(start, start + per_call) % n
            self.attempted += per_call
            with run.recorder.span("call", passages=per_call):
                out = self.student.encode_documents([self.passages[i] for i in idx],
                                                    batch_size=int(tr["batch_size"]))
            self.tokens += int(self.real[idx].sum())
            self.emb[idx] = out
            self.seen[idx] = True
            start += per_call
            if time.perf_counter() >= run.deadline:
                break
        run.close_window()
        run.tracer.stop()

    def end_to_end(self) -> dict:
        return {"encode_tokens_per_s": self.tokens / self.run.window_s}

    def release(self) -> None:
        self.student.cleanup()
        del self.student

    def sample(self) -> list[int]:
        return sample(np.flatnonzero(self.seen), self.real, int(self.tr["check_passages"]),
                      int(self.tr["check_longest"]), self.run.seed)

    def reference_embeddings(self, idx: list[int], precision: str) -> np.ndarray:
        dev = self.run.device
        tree = draw_tree(self.arch, self.run.seed, dev)
        tok = tokenizer()
        order = sorted(idx, key=lambda i: self.real[i])
        out = {}
        with torch.no_grad():
            for s in range(0, len(order), 64):
                chunk = order[s:s + 64]
                length = int(max(self.real[i] for i in chunk))
                ids, mask = tok.frame([self.prefix + self.passages[i] for i in chunk], length)
                got = embed(tree, self.arch, torch.from_numpy(ids).to(dev),
                            torch.from_numpy(mask).to(dev), precision)
                out.update(zip(chunk, got.double().cpu().numpy()))
        return np.stack([out[i] for i in idx])

    def numbers(self, got: np.ndarray, want: np.ndarray) -> dict:
        return {"embedding_gap": float(np.max(np.linalg.norm(got - want, axis=1)))}

    def check(self) -> dict:
        idx = self.sample()
        return self.numbers(self.emb[idx].astype(np.float64),
                            self.reference_embeddings(idx, "float32"))

    def control(self, precision: str) -> dict:
        idx = self.sample()
        return self.numbers(self.reference_embeddings(idx, precision),
                            self.reference_embeddings(idx, "float32"))
