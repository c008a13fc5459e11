"""``/search`` below HTTP: a closed loop of clients on the micro-batcher of
the app that ``create_app`` builds, over an exact int8 index.

Set-up draws the student's weights and the index rows on the device from the
seed, saves the student where the app loads it, starts the app (no index
directory: the rows go in through ``AppState.use_index``), warms every pair
of batch and length bucket the traffic reaches, then runs the closed loop
for ``warmup_seconds`` before the window opens. Each client sends a query,
waits for its answer and sends the next; a request's latency runs from its
submission to its answer.

After the window a sample of the completed requests, drawn from the seed and
holding the longest queries, is compared with the plain reference: the
query encoded in float32, quantized, and an exact top-k over the same rows
quantized again by the reference.
"""

from __future__ import annotations

import asyncio
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.harness import texts
from benchmark.harness.program import (bert_config, forward_describe, prefix_tokens, sample,
                                       tokenizer)
from benchmark.harness.weights import draw_tree, sub_seed
from benchmark.reference.bert import arch_from_config, embed
from benchmark.reference.search import ExactTopK, quantize

BLOCK_ROWS = 1 << 20


def index_block(seed: int, rows: int, dim: int, block: int, device) -> torch.Tensor:
    """Unit rows ``[block * BLOCK_ROWS, ...)`` of the index, drawn on the
    device (the same for the program and the reference)."""
    lo = block * BLOCK_ROWS
    n = min(BLOCK_ROWS, rows - lo)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2, block))
    x = torch.randn(n, dim, generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


class Entry:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.arch = arch_from_config(self.cfg)
        self.rows = int(self.tr["index_rows"])
        self.k = int(self.tr["k"])
        self.attempted = self.failed = 0
        self.done: list[tuple] = []  # (query index, t_submit, t_done, scores, ids)
        self.warm_done: list[tuple] = []  # (t_submit, t_done) of requests sent before the window
        self.spans: list = []

    # -- set-up ----------------------------------------------------------

    def _queries(self, stream: int, n: int) -> tuple[list[str], np.ndarray]:
        rng = np.random.default_rng(sub_seed(self.run.seed, stream))
        lens = texts.lengths(self.tr["query_tokens"], n, rng)
        return texts.texts(lens, rng), lens

    def setup(self) -> None:
        from sskd_tpu_torch.config import Settings
        from sskd_tpu_torch.index.builder import IndexBuilder
        from sskd_tpu_torch.models.student import StudentModel
        from sskd_tpu_torch.serve.app import create_app

        run, dev = self.run, self.run.device
        self.queries, self.qlens = self._queries(3, int(self.tr["query_pool"]))
        self.warm_queries, _ = self._queries(4, 4096)
        settings = Settings.from_dict({**self.tr["settings"],
                                       "precision": {"compute_dtype": self.cfg["compute_dtype"]}})
        self.prefix = settings.student.query_prefix
        self.prefix_n = prefix_tokens(self.prefix)
        ckpt = tempfile.mkdtemp(prefix="bench-student-")
        try:
            student = StudentModel(self.cfg["source"], device=dev, config=bert_config(self.cfg),
                                   params=draw_tree(self.arch, run.seed, dev))
            student.save(ckpt)
            del student
            self.app = create_app(settings, student_model_path=ckpt, device=dev)
            self.loop = asyncio.new_event_loop()
            self.executor = ThreadPoolExecutor(1, thread_name_prefix="bench-batch")
            self.loop.set_default_executor(self.executor)
            self.loop.run_until_complete(self.app.startup())
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        state = self.app.state
        dim = self.arch.hidden
        rows = torch.empty((self.rows, dim), device=dev)
        for b in range(-(-self.rows // BLOCK_ROWS)):
            block = index_block(run.seed, self.rows, dim, b, dev)
            rows[b * BLOCK_ROWS: b * BLOCK_ROWS + block.shape[0]] = block
        host = rows.cpu().numpy()
        del rows, block
        builder = IndexBuilder(embedding_dim=dim, index_type=self.tr["index_type"],
                               dtype=self.tr["index_dtype"], device=dev)
        builder.build_from_arrays(host, range(self.rows))
        del host
        state.use_index(builder)
        self.state = state
        self._warm_buckets()
        self._instrument()

    def _warm_buckets(self) -> None:
        """One search at each (batch bucket, length bucket) the traffic can
        reach."""
        from sskd_tpu_torch.models.student import bucket_length

        dev = torch.device(self.run.device)
        qd = self.tr["query_tokens"]
        seq = {}
        for n in range(qd["min"], qd["max"] + 1):
            seq.setdefault(bucket_length(n + self.prefix_n + 2, 512, dev), n)
        largest = self.tr["settings"]["service"]["micro_batch_max_size"]
        batches = {bucket_length(b, 256, dev): b for b in range(1, largest + 1)}
        words = texts.words()
        for _, n in sorted(seq.items()):
            text = " ".join(words[i % len(words)] for i in range(n))
            for b in batches.values():
                self.state.fused_searcher.search_texts([text] * b, self.k)

    def _instrument(self) -> None:
        rec, tracer = self.run.recorder, self.run.tracer
        student, searcher = self.state.student, self.state.fused_searcher
        rec.wrap(student, "tokenize_batch", "tokenize")
        rec.wrap(student, "forward_batch", "forward", forward_describe)
        rec.wrap(searcher, "_topk", "topk",
                 lambda q, k, engine: (None, {"B": int(q.shape[0])}))
        batcher = self.state.search_batcher
        inner = batcher.batch_fn
        prefix_n = self.prefix_n

        def batch_fn(items):
            tracer.boundary()
            real = [prefix_n + 2 + len(text.split()) for text, _ in items]
            with rec.span("batch", tokens=real):
                return inner(items)

        batcher.batch_fn = batch_fn

    # -- the window ------------------------------------------------------

    def window(self) -> None:
        self.loop.run_until_complete(self._closed_loop())
        self.loop.run_until_complete(self.loop.run_in_executor(None, self.run.tracer.stop))

    async def _closed_loop(self) -> None:
        from sskd_tpu_torch.utils.tracing import SPAN_INDEX_SEARCH, TRACER

        run, batcher = self.run, self.state.search_batcher
        warm = float(self.tr["warmup_seconds"])
        stop = False
        counter = iter(range(1 << 62))
        pool = len(self.queries)

        async def client() -> None:
            while not stop:
                i = next(counter)
                measured = run.recorder.window_open
                text = (self.queries[i % pool] if measured
                        else self.warm_queries[i % len(self.warm_queries)])
                t = time.perf_counter()
                if measured:
                    self.attempted += 1
                try:
                    scores, ids = await batcher.submit((text, self.k))
                except Exception:  # a failed request counts against the run
                    if measured:
                        self.failed += 1
                    continue
                done = time.perf_counter()
                if measured:
                    self.done.append((i % pool, t, done, scores, ids))
                else:
                    self.warm_done.append((t, done))

        tasks = [asyncio.ensure_future(client()) for _ in range(int(self.tr["clients"]))]
        await asyncio.sleep(warm)
        TRACER.clear()
        wall0 = time.time()
        run.open_window()
        await asyncio.sleep(max(0.0, run.deadline - time.perf_counter()))
        run.close_window()
        stop = True
        await asyncio.gather(*tasks)
        wall1 = wall0 + run.window_s
        self.spans = [s for s in TRACER.recent(SPAN_INDEX_SEARCH, limit=TRACER.MAX_SPANS)
                      if wall0 <= s.start_s <= wall1]
        await self.app.shutdown()

    # -- results ---------------------------------------------------------

    def end_to_end(self) -> dict:
        """Every request answered inside the window, whenever it was sent."""
        t0, t1 = self.run.window_t0, self.run.window_t1
        lat = [(d - t) * 1e3 for t, d in [(d[1], d[2]) for d in self.done] + self.warm_done
               if t0 <= d <= t1]
        return {"search_qps": len(lat) / self.run.window_s,
                "search_p95_ms": float(np.percentile(lat, 95))}

    def release(self) -> None:
        self.loop.close()
        self.executor.shutdown(wait=True)
        self.state.fused_searcher = None
        self.state.index_builder = None
        self.state.student = None
        del self.state, self.app

    # -- the comparison --------------------------------------------------

    def sample(self) -> list[tuple]:
        done = [d for d in self.done if d[2] <= self.run.window_t1 + 60.0]
        real = np.array([self.qlens[d[0]] for d in done])
        picked = sample(np.arange(len(done)), real, int(self.tr["check_requests"]),
                        int(self.tr["check_longest"]), self.run.seed)
        return [done[j] for j in picked]

    def reference_embeddings(self, qidx: list[int], precision: str) -> torch.Tensor:
        dev = self.run.device
        tree = draw_tree(self.arch, self.run.seed, dev)
        tok = tokenizer()
        txt = [self.prefix + self.queries[i] for i in qidx]
        length = 2 + max(len(tok.tokenize(t)) for t in txt)
        ids, mask = tok.frame(txt, length)
        with torch.no_grad():
            return embed(tree, self.arch, torch.from_numpy(ids).to(dev),
                         torch.from_numpy(mask).to(dev), precision)

    def sweep(self, searches: list[ExactTopK]) -> None:
        dev = self.run.device
        for b in range(-(-self.rows // BLOCK_ROWS)):
            values, scales = quantize(index_block(self.run.seed, self.rows, self.arch.hidden, b,
                                                  dev))
            for s in searches:
                s.add_block(b * BLOCK_ROWS, values, scales)

    def numbers(self, ref: ExactTopK, ids: np.ndarray, scores: np.ndarray) -> dict:
        """The gaps of answers ``ids``/``scores`` [Q, k] against the
        reference search ``ref`` that watched those ids."""
        bad = 0
        for row in ids:
            live = row[row >= 0]
            bad += int(len(live) != self.k or len(set(live.tolist())) != len(live)
                       or (live >= self.rows).any())
        watched = ref.watch_scores.cpu().numpy().astype(np.float64)
        best = ref.best.cpu().numpy().astype(np.float64)
        order = -np.sort(-np.nan_to_num(watched, nan=-1e9), axis=1)
        return {
            "bad_answers": float(bad),
            "rank_gap": float((best - order).max()),
            "score_gap": float(np.nanmax(np.abs(scores.astype(np.float64) - watched))),
        }

    def check(self) -> dict:
        picked = self.sample()
        ids = np.stack([np.asarray(d[4], np.int64) for d in picked])
        scores = np.stack([np.asarray(d[3], np.float64) for d in picked])
        with torch.no_grad():
            q = self.reference_embeddings([d[0] for d in picked], "float32")
            ref = ExactTopK(q, self.k, torch.from_numpy(np.clip(ids, 0, self.rows - 1))
                            .to(self.run.device))
            self.sweep([ref])
        return self.numbers(ref, ids, scores)

    def control(self, precision: str) -> dict:
        """The check's numbers with the reference at ``precision`` in the
        program's place, over the same sampled requests."""
        picked = self.sample()
        qidx = [d[0] for d in picked]
        with torch.no_grad():
            low = ExactTopK(self.reference_embeddings(qidx, precision), self.k,
                            torch.zeros((len(qidx), 1), dtype=torch.int64, device=self.run.device))
            self.sweep([low])
            ref = ExactTopK(self.reference_embeddings(qidx, "float32"), self.k, low.best_ids)
            self.sweep([ref])
        return self.numbers(ref, low.best_ids.cpu().numpy(), low.best.cpu().numpy())
