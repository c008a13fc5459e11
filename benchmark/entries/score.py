"""Mining's second stage: the cross-encoder teacher scores each query with
its candidates in rank order, through ``TeacherModel.score``.

Set-up draws the teacher's weights on the device and hands them to
``TeacherModel`` through ``params``, draws the queries and their candidate
passages, and scores one chunk that reaches each length bucket the traffic
can reach. The window then scores call after call, each call the pairs of
``queries_per_call`` queries, and closes at the end of the first call that
ends past the run's seconds. Afterwards a sample of the scored pairs, drawn
from the seed and holding the longest, is scored again by the plain
reference in float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import texts
from benchmark.harness.program import (bert_config, forward_describe, sample, tokenizer,
                                       warm_lengths)
from benchmark.harness.weights import draw_tree, sub_seed
from benchmark.reference.bert import arch_from_config, cross_logits


class Entry:
    cross_encoder = True

    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.arch = arch_from_config(self.cfg)
        self.max_len = int(self.tr["max_seq_length"])
        self.attempted = self.failed = 0
        self.tokens = 0
        self.logits: dict[int, float] = {}  # pair -> the program's logit, for pairs in the window

    def setup(self) -> None:
        from sskd_tpu_torch.models.teacher import TeacherModel

        run, tr = self.run, self.tr
        rng = np.random.default_rng(sub_seed(run.seed, 3))
        nq, nc, per = int(tr["query_pool"]), int(tr["candidates"]), int(tr["queries_per_call"])
        qlens = texts.lengths(tr["query_tokens"], per, rng, nq // per)
        dlens = texts.lengths(tr["passage_tokens"], per * nc, rng, nq // per)
        self.queries = texts.texts(qlens, rng)
        passages = texts.texts(dlens, rng)
        self.pairs = [(self.queries[i // nc], passages[i]) for i in range(nq * nc)]
        self.real = np.minimum(3 + np.repeat(qlens, nc) + dlens, self.max_len)
        self.teacher = TeacherModel(self.cfg["source"], device=run.device,
                                    config=bert_config(self.cfg),
                                    params=draw_tree(self.arch, run.seed, run.device, True),
                                    max_seq_length=self.max_len)
        self._warm()
        rec = run.recorder
        rec.wrap(self.teacher, "tokenize_pairs", "tokenize")
        rec.wrap(self.teacher, "forward_batch", "forward", forward_describe)

    def _warm(self) -> None:
        """One chunk at each length bucket that a chunk of the traffic can
        reach."""
        q = self.queries[0]
        qn = len(q.split())
        words = texts.words()
        batch = int(self.tr["batch_size"])
        for n in warm_lengths(self.real, batch, self.max_len, self.run.device):
            d = " ".join(words[i % len(words)] for i in range(max(1, n - 3 - qn)))
            self.teacher.score([(q, d)] * batch, batch_size=batch)

    def window(self) -> None:
        run, tr = self.run, self.tr
        per_call = int(tr["queries_per_call"]) * int(tr["candidates"])
        n_pairs = len(self.pairs)
        start = 0
        run.open_window()
        while True:
            run.tracer.boundary()
            idx = [(start + j) % n_pairs for j in range(per_call)]
            self.attempted += per_call
            with run.recorder.span("call", pairs=per_call):
                out = self.teacher.score([self.pairs[i] for i in idx],
                                         batch_size=int(tr["batch_size"]))
            self.tokens += int(self.real[idx].sum())
            self.logits.update(zip(idx, out))
            start += per_call
            if time.perf_counter() >= run.deadline:
                break
        run.close_window()
        run.tracer.stop()

    def end_to_end(self) -> dict:
        return {"encode_tokens_per_s": self.tokens / self.run.window_s}

    def release(self) -> None:
        self.teacher.cleanup()
        del self.teacher

    def sample(self) -> list[int]:
        return sample(np.array(sorted(self.logits)), self.real, int(self.tr["check_pairs"]),
                      int(self.tr["check_longest"]), self.run.seed)

    def reference_logits(self, idx: list[int], precision: str) -> np.ndarray:
        dev = self.run.device
        tree = draw_tree(self.arch, self.run.seed, dev, True)
        tok = tokenizer()
        order = sorted(idx, key=lambda i: self.real[i])
        out = {}
        with torch.no_grad():
            for s in range(0, len(order), 32):
                chunk = order[s:s + 32]
                length = int(max(self.real[i] for i in chunk))
                ids, mask, types = tok.frame_pairs([self.pairs[i] for i in chunk], length)
                got = cross_logits(tree, self.arch, *(torch.from_numpy(a).to(dev)
                                                      for a in (ids, mask, types)), precision)
                out.update(zip(chunk, got.double().cpu().numpy()))
        return np.array([out[i] for i in idx])

    def numbers(self, got: np.ndarray, want: np.ndarray) -> dict:
        return {"logit_gap": float(np.max(np.abs(got - want)))}

    def check(self) -> dict:
        idx = self.sample()
        got = np.array([self.logits[i] for i in idx], np.float64)
        return self.numbers(got, self.reference_logits(idx, "float32"))

    def control(self, precision: str) -> dict:
        idx = self.sample()
        return self.numbers(self.reference_logits(idx, precision),
                            self.reference_logits(idx, "float32"))
