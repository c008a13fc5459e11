#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sskd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal when it fails:

1. build   — compile every csrc/*.cu with nvcc (one process per source, all
             at once) and print each kernel's registers, shared memory and
             spills;
2. kernels — each kernel against its plain torch version on the card at the
             shapes of the main path (binmax / exact engine: f32, int8 and
             int4 at 1M x 384, B in {1, 16, 256}, int8 also at 32 and 64,
             int4 and f32 at 64, k in {10, 100}, and bf16 at B in {1, 16, 64, 256}, k in {10,
             40}, every bf16 launch on its bf16 route within 1e-5, beside
             cuBLAS's bf16 product with the query rounded and the f32 route
             over the widened rows, bf16 bin_gather on its tensor-core route
             (the f32 query as three bf16 terms); int8 binmax, binmax_strided
             and bin_gather on their tensor-core routes, int4 too (bit for
             bit, cold L2 cache, beside torch._int_mm over the rows unpacked
             in the call and beforehand, and bin_gather beside index_select +
             bmm of the chosen rows and beside bin_gather_kernel, the
             CUDA-core kernel it replaced on these rows), int4 binmax,
             binmax_strided and bin_gather also at 1M x 1056 (528 packed
             bytes, past the tensor-core route) on their dp4a kernels, B in
             {1, 16, 256}, bit for bit, bf16 bin_gather at D = 528 on
             bin_gather_kernel's bf16 mode within 1e-5, f32 binmax and
             binmax_strided on the
             register-tiled CUDA-core kernels, f32 bin_gather on its
             tensor-core route (bin_gather_f32_tc_kernel, three TF32
             products) within 1e-5, both of its layouts (the pairs in their
             own order and sorted by bin) bit for bit the wrapper's, beside
             the sort and bin_gather_kernel (the kernel f32 rows took
             before) on the same inputs, with the int8 bin_gather's pairs in
             their own order against sorted by bin on corpus-derived queries,
             binmax also with the L2 cache flushed before each launch, the
             wrapper's host microseconds by part, and binmax_strided at
             several block counts for approx_blocks;
             flash_attn_fwd: [256, 12, L, 32] bf16 on its tensor-core route,
             L in {128, 256, 512}, each element within its rounding bound,
             timed beside SDPA and plain_attention (the FLASH_MIN_L
             crossover), and f32 (its tensor-core route) at L = 512 within
             1e-5; dropattn_fwd / dropattn_bwd: [256, 12, 192, 32],
             [32, 12, 64, 32], [256, 12, 512, 32] and [32, 12, 264, 32] bf16
             and [256, 12, 192, 32] f32 with a random padding bias, p in {0,
             0.1}, each element within its rounding bound (f32 within 1e-5),
             each kernel on the route its (dtype, L) selects (the backward
             holding the head at L = 64 and 192 in bf16, streaming it past
             256 and in f32) and bitwise equal over two launches, the
             kernels' keep-mask equal to the plain one bit for bit (f32 at
             L = 256; bf16 at L = 192 and 512 through the resident and the
             streaming backward; the streaming backward's packed keep bits
             at L = 512 and 264), each timed beside SDPA, the byte bound and
             the exp and Philox floors, the streaming kernels' device time
             summed over their three launches, ptxas's registers and
             spills, the f32 forward (dropattn_fwd_tc_tf32_kernel<32>)
             beside SDPA's device time, its three TF32 passes and the FMA
             bound of the kernel it replaced, and the streaming kernels at
             [256, 12, 192, 32] bf16 beside the resident one; binmax_strided,
             the approx engine's pass, at every binmax case;
             cell_gather and cell_gather_b1 over 977 cells x 1,024 rows x
             384, nprobe 64: int8 at B in {1, 16, 64} bit for bit (B > 1 on
             cell_gather's tensor-core route), f32 at B in {1, 16} and bf16
             (the query rounded to bf16) at B in {1, 16, 64} within 1e-5, a
             ragged case, nprobe 11 over cells of 768 rows, and
             cell_gather_b1's kernel alone on the card; the teacher's head
             dim 64: dropattn_fwd / dropattn_bwd at [32, 16, 64, 64] (both on
             the tensor cores, f32 as three TF32 products, the backward
             holding the head; the streaming kernels timed beside it), [8,
             16, 512, 64] f32 and bf16, [32, 16, 512, 64] f32 and the ragged
             [8, 16, 200, 64] f32 and [8, 16, 216, 64] bf16 (the backward
             streaming the head), p in {0, 0.1}, and flash_attn_fwd
             at [32, 16, 512, 64] on its tensor-core route, f32 and bf16,
             each on the route (dtype, d, L) selects, one tensor-core launch a
             call where that is the route, counted at d = 64, bitwise
             repeatable, f32 within 1e-5 and bf16 within the rounding bounds,
             the keep-mask read back bit for bit (f32 at L = 64, 128, 256 and
             512 through the tensor-core forward and both backward routes,
             bf16 at 192), the streaming backward's packed keep bits at
             L = 200, ptxas's registers and spills beside each time); head
             dim 16 (BertConfig.tiny, the pipeline phase's --tiny models):
             dropattn_fwd / dropattn_bwd at [256, 4, 192, 16] and
             [32, 4, 64, 16] bf16 (tensor cores; the backward holding the
             head) and [32, 4, 64, 16] f32 (tensor-core forward, streaming
             backward), p in {0, 0.1}, the keep-mask bit for bit, bitwise
             repeatable, bf16 within the rounding bounds and f32 within 1e-5
             (1 + |want|), each timed beside SDPA with dropout; the bf16
             backward on the three-pass kernel (dropattn_bwd_tc_3pass_kernel)
             beside the kernel it replaced (dropattn_bwd_tc_kernel<16>,
             whose bits it gives) and the streaming route, each within its
             bound, and their device times; flash_attn_fwd in bf16 at
             [256, 4, 512, 16] (a ragged mask, a row with no live key),
             [64, 4, 200, 16] and [1, 4, 512, 16] on its tensor-core route
             (flash_fwd_tc2_kernel<16, 2, 4>), one launch a call at d = 16,
             bitwise repeatable, within its rounding bound, its time beside
             the CUDA-core kernel the route took before (built from
             tools/flash_d16_variants.cuh beside the product), SDPA, the
             byte bound and the exp floor, with both kernels' registers:
             error, time per launch (CUDA events, and on the card alone from
             the profiler for the top-k, cell and d = 64 attention kernels),
             the bound and yardsticks that the port never calls;
3. serve   — the main path at full e5-small-v2 width (12 layers, hidden 384,
             bf16, seeded random weights): encode 8,192 passages of at least
             510 tokens (L = 512, batch 256), fill an int8 exact index to
             1,000,000 rows with seeded unit vectors, save and load it, serve
             it with create_app on 127.0.0.1, send single and concurrent
             /search requests, and check every response against the plain
             engine on the same query embeddings; every kernel must have been
             launched by this phase, every flash, binmax and bin_gather launch
             on the tensor-core route; then recall@10 of the int8 exact search
             against exact f32 search over the original vectors (gate 0.97);
4. train   — KDTrainer.train on seeded synthetic samples at full
             e5-small-v2 width (bf16 compute, f32 parameters, hidden and
             attention dropout 0.1, remat "full"), the KD recipe of
             configs/kd.yaml: 512 queries x 8 docs, batch 32, query_len 64,
             doc_len 192, one epoch (16 steps); every loss finite, the dropattn
             launches of the train path equal to the count the code implies,
             every forward and backward on the tensor-core route,
             the first update (lr 0) leaving the parameters as they were and
             the second moving them within AdamW's bound, best_model reloaded
             and used to encode; then one step's gradients through the
             kernels no farther from the plain pair's than bf16 rounding of
             the attention moves them; ms per step (CUDA events and the
             loop's host cadence), samples/s, peak device memory and the
             device busy share over a few steps; then KDTrainer.train at
             doc_len 512 (the length configs/kd.yaml encodes passages at),
             query_len 64, 4 steps of 32 queries x 8 docs of 300-480 words:
             every loss finite, the dropattn launches the code implies,
             every doc-tower backward (L = 512) on the streaming route and
             every query-tower one holding its head, one step's gradients
             vs the plain pair's within bf16 rounding's distance at 4
             queries x 8 docs (three batches), ms per step and peak memory;
5. clustered — the cell-probe path at full width: a seeded 1,000,000 x 384
             corpus of 1,000 topics in 32 dimensions, built into a clustered
             int8 index (977 cells x 1,024 rows, nprobe 64), saved and loaded;
             IndexBuilder.search with one query at a time (cell_gather_b1), 16
             and 64 (cell_gather) and 256 (the approx sweep); the index served
             by create_app with SSKD_SERVE_CELL_PROBE=1 to 1 and to 32
             closed-loop clients, then once more without the variable (approx);
             every result against the same engine over the plain versions on
             the same embeddings, 0 mismatched ids; with every cell probed, the
             exact engine's ids; every cell_gather and binmax_strided launch
             on the tensor-core route; recall@10 at nprobe 64 against exact search
             over the same rows (gate 0.90), validate() of the index as
             clustered and as approx (gate 0.97 for approx), and ms per search
             of the clustered, approx and exact engines at B in {1, 16, 64};
5b. sharded — the serve phase's 1,000,000 x 384 rows as int8 exact, approx
             and refined (refine_m 40) indexes, and the clustered phase's
             int8 index, on a one-device CUDA mesh: ShardedIndex.search and
             ShardedFusedSearcher at B in {1, 16, 64}, ids equal to the
             single-device engines' (IndexBuilder.search, FusedSearcher) and
             scores within 1e-6, every sharded kernel launched on that path;
             each kernel route on the second half of the rows at
             index_offset N/2 (exact, approx, clustered at B = 1 and 16,
             refine) against its plain version (ids equal, scores equal,
             the exact engine within 1e-5); two shards on the one card
             against the single-device exact ids; ms per batch of each;
             the exact index saved as sskd-sharded-1 for 7b (f);
6. refine  — the same topical corpus (made once for both phases) built into
             five indexes, each saved and loaded: (a) int8 approx and (b) int4
             exact, both with refine_m 40 (bf16 refine rows), (c) bf16 exact,
             (d) bf16 approx, (e) bf16 clustered (977 cells x 1,024 rows,
             nprobe 64); IndexBuilder.search of each at B = 1 x 8, 16, 64 and
             256, (a) with its refine rows on the device and on the host;
             (a) served by create_app with index.refine_storage "device"
             (1 and 32 closed-loop clients), then "host" (the same), and (b)
             once (the refined engine over int4 candidates); every result
             against the same engine over the plain versions on the same
             embeddings (0 ids that differ but at ties within 1e-5, and none
             at all for (a) and (b)); every launch on bf16 rows on a bf16
             route, (c)'s bin_gather launches on its bf16 tensor-core route,
             the candidates of (a) from the tensor-core strided pass and of
             (b) from binmax and bin_gather on the tensor cores;
             recall@10 against exact f32 search over the original rows
             ((a) at least its unrefined int8 sweep's and 0.97, (b) above
             its unrefined int4 search's, (c) 0.97, (e) 0.90), validate()
             ((a), (c), (d) 0.97, (e) 0.90, (b) through the refined engine
             above its own unrefined value), and ms per search of the
             refined (device and host), int8 approx, bf16 exact, approx and
             clustered engines and the approx engine over (b)'s int4 rows
             (its strided pass on the tensor cores, its result the plain
             engine's) at B in {1, 16, 64};
7. teacher — the cross-encoder at full bge-reranker-large width (24
             layers, hidden 1024, 16 heads of 64, FFN 4096, vocab 250,002,
             roberta positions; seeded random weights, f32 compute, dropout
             0.1): TeacherTrainer.train on 720 seeded triples (1 positive to 8
             negatives) with the CLI's defaults (16 steps of 32 at max_len
             64, lr 1e-3, pos_fraction 0.25): every loss finite, 24
             dropattn_fwd and 24 dropattn_bwd launches a step, all at d = 64
             and on the tensor cores, step 1 (lr 0) leaving the parameters
             bit for bit, one
             step's gradients through the kernels within 1e-3 of the plain
             pair's; then 4 steps at max_len 512 (batch 32, passages of
             300-480 words): every loss finite, 24 + 24 dropattn launches a
             step at d = 64, every backward streaming the head, one step's
             gradients within 1e-3 of the plain pair's at a batch of 8, ms
             per step, samples/s and peak memory; saved and reloaded bit for
             bit; TeacherModel.score of
             1,024 pairs in chunks of 32 whose buckets reach 512 (every
             L = 512 chunk 24 flash_attn_fwd launches at d = 64, all on the
             tensor cores), within 1e-4 (1 + |s|) of the same scores through
             the plain versions, and one chunk's device time by kernel from
             a checked profiler window; then create_app over the serve
             phase's index and student with search.rerank_enabled and the
             saved teacher, /search with rerank=true from 1 client and then
             8 closed-loop clients: every response reranked, in the order and
             with the scores of TeacherModel.score on its pairs (ties within
             1e-5 excepted), every flash launch at d = 64 on the tensor
             cores; ms per step, samples/s, peak memory, pairs/s, rerank ms
             and queries/s;
7b. distributed — (a) initialize_distributed from the SSKD_* variables
             at world size 1 on NCCL, an all-reduce and an all-gather
             (plain and differentiable) of CUDA tensors, the barrier and the
             broadcast of its gloo group; (b)
             KDTrainer(mesh=create_mesh(data_parallel=1)) at full
             e5-small-v2 width with the train phase's settings (bf16
             compute, remat "full", batch 32 x 8 docs, L 64 / 192) and
             in-batch negatives against the single-device trainer from the
             same init: 3 steps at dropout 0, parameters bit for bit (or
             within 1e-6 (1 + |p|)), then 2 steps at dropout 0.1, every
             loss finite and the dropattn_fwd / dropattn_bwd launches the
             code implies, all on the tensor cores; ms per step of both;
             (c) set_mesh encode equal to encode; (d) the teacher phase's
             saved teacher over 64 pairs whose chunks reach L = 512,
             shard_tensor_parallel over a one-device mesh and over two
             slices of the one card (8 heads and FFN 2,048 each), scores
             within 1e-4 (1 + |s|) of the unsharded ones, 24 flash_attn_fwd
             launches an L = 512 chunk a slice at d = 64, all on the tensor
             cores, the placement summary and ms per chunk of each;
             (e) the index axis over the NCCL group of one rank: the serve
             phase's 1M x 384 int8 exact index and the clustered phase's
             int8 index on two entries of cuda:0 of a mesh over the group,
             the candidates meeting in the group's all-gather, at B in
             {1, 16, 64}: the exact ids the single-device engine's, the
             clustered ids the same two shards' on a mesh of this process
             (and over one group entry the single-device engine's), 0
             mismatches, scores within 1e-6, every binmax, bin_gather and
             cell_gather launch on the tensor cores, ms per batch beside the
             one-process mesh's; (f) two gloo ranks (this script with
             --shard-rank, each an entry of cuda:0; NCCL refuses two ranks
             on one card) each loading its half of the sharded phase's
             saved index: each rank's index memory about half the
             one-process index's, its ids the single-device engine's at B in
             {1, 16, 64}, its binmax and bin_gather launches on the tensor
             cores, ms per batch of each rank and of the one-process
             two-shard index;
8. eval    — KDEvaluator on the card: (a) the JAX package's demo checkpoints
             (artifacts/demo/{run_kd/best_model, vanilla, teacher}), each
             read from its params.msgpack, over load_eval_inputs(test.jsonl,
             600): evaluate_retrieval of both students and
             evaluate_retrieval_teacher, vanilla and the teacher within 1e-3
             of their *_metrics.json in every metric, kd_student within 1e-3
             of the same evaluator on the CPU, and the acceptance gate
             printed as `semantic-kd compare` prints it, which must be
             FAILED, the JAX package's verdict on these files (tiny models:
             no kernel runs); (b) at full e5-small-v2 width in f32 (seeded
             weights): evaluate_retrieval over the 8,192 passages and 1,000
             12-word spans of distinct passages (flash in f32 at d = 32 on
             flash_fwd_tc_tf32_kernel<32>, 384 launches, every one on the
             tensor cores; binmax and bin_gather in f32,
             one launch each for the 1,000 queries, the gather's on
             bin_gather_f32_tc_kernel over its pairs sorted by bin), its top-20 ids against
             cosine_topk_core but at ties within 1e-5, its metrics within
             1e-6 of those of the plain ids, the encode within 1e-4 (1 + |x|)
             of plain attention's on 1,024 passages;
             evaluate_retrieval_chunked over 1,024 passages in
             TextChunker(512, 80) windows (two each), the doc ranking the
             MaxSim of the plain scores; evaluate_retrieval_reranked with
             the teacher phase's saved teacher (64 queries, rerank_k 10), in
             TeacherModel.score's order, every flash launch at d = 64 on the
             tensor cores; evaluate_ranking_quality on 64 queries x 8
             passages, Kendall tau within 1e-6 of scipy's; those three
             kernels at the eval shapes against their plain versions, beside
             SDPA or matmul and their bounds; (c) the native WordPiece core
             attached, the 8,192 passages' ids equal through it and through
             pure Python, and the ms each way;
9. pipeline — run_train_pipeline end to end (data, parquet through the
             port's own reader and writer, integrity, BM25, mining, KD):
             (a) scripts/run_demo_pipeline.sh's recipe at stage 2 over a
             copy of artifacts/demo's raw splits with its teacher and its
             vanilla init (read from params.msgpack): the 420 queries'
             negatives equal run_kd/mined_stage2.json (ids; scores within
             1e-4 (1 + |s|), order only among near ties), every loss finite,
             every dropattn_fwd launch of the f32 student on the tensor
             cores, the [B, h, L, d] of every dropattn launch recorded (the
             commonest timed alone), best_model reloaded, its nDCG@10 on test.jsonl above the
             vanilla init's (reported with MRR@10, recall@10 and nDCG@20
             beside the JAX files and the gate, which is not enforced); (b)
             the --tiny defaults: 48 generated demo rows prepared and
             checked by require_integrity, stage 3 with BertConfig.tiny (the
             student bf16, every dropattn launch at d = 16 on the tensor
             cores, every backward that holds its head on
             dropattn_bwd_tc_3pass_kernel), the trained student's bf16
             encode of 256 passages of at least 512 tokens (2 flash launches
             at [256, 4, 512, 16], on the tensor cores; every embedding's
             cosine with the checkpoint's on the CPU >= 0.999; docs/s),
             then 4 TeacherTrainer steps of the tiny teacher in f32
             (d = 16: tensor-core forward, streaming backward); (c) full width
             (e5-small-v2 bf16, bge-reranker-large f32, seeded, vocabulary
             fitted to the corpus) at stage 3 over 128 queries, bm25 top
             100, batch 32: every loss finite, more than half the queries
             with negatives, each union at most 5 teacher ids and the ANCE
             picks, every dropattn launch at d = 32 on the tensor cores;
             seconds per pipeline step and the teacher's pairs a second;
10. cli    — the port's own entry point, `python -m sskd_tpu_torch.cli.main`,
             each command a process of its own at the serve phase's width
             (its seeded student and 1,000,000-row index): `index build
             --dtype int8 --method exact` over the 8,192 passages written as
             a chunk parquet by the port's writer, its rows bit for bit an
             in-process IndexBuilder build's, and `index validate`;
             `serve` of the 1M-row index under configs/service.yaml with the
             cache, API keys (a hash from keys.py) and the rate limit turned
             on: 401 without a key, 64 queries' ids equal to the plain
             engine's over /encode's embeddings, a cached repeat, 429 past the
             burst, /docs, /openapi.json and /metrics, 200 sequential timed
             requests (p50, queries/s), /index/load of the 8,192-row index
             (the result cache flushed), SIGTERM ending it with exit code 0;
             `serve --hybrid-bm25` whose fused ids equal HybridSearcher's;
             `export` (min cosine >= 0.99, the int8 file read back equal);
             `compare` on artifacts/demo (exit 1, FAILED, every number within
             1e-3 of eval (a)'s); `demo-data`, `prepare`, `integrity` and
             `train --tiny --epochs 1` beside the index build; `doctor
             --index` naming the card; `config --production-audit` (exit 1,
             the JAX package's audit of the defaults). Every wait bounded,
             each command's seconds recorded.

The line before the last is {"kernels": [...]}, the one before it the card's
name and power limit, the last {"ok": true, "device": {...}}. The full
record goes to chiprun_out/chip_smoke.json. Exits non-zero without a result
when CUDA is not available or a phase fails.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import ctypes
import http.client
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
# dense, per second: tensor cores (bf16, int8, tf32) and the CUDA cores' f32 FMA
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9  # H100 SXM: SMs and boost clock, for the exp floor
L2_FLUSH_BYTES = 256 << 20  # written between launches to empty the 50 MB L2 cache
STREAM_HOLD_CYCLES = 400_000_000  # about 0.2 s of the SM clock: longer than 16 eager searches
N_DOCS = 8192  # passages encoded at L = 512
N_ROWS = 1_000_000  # rows of the served index (and of the kernel cases)
SERVE_KERNELS = ("binmax", "bin_gather", "flash_attn_fwd")
N_CELLS, CELL_ROWS, NPROBE = 977, 1024, 64  # auto_cells(1,000,000) and the default nprobe
WORDS = (
    "the quick brown fox jumps over a lazy dog and runs to search for semantic meaning "
    "in documents queries passages models training data index vector embedding score "
    "teacher student distillation knowledge what is how why when where who which does can"
).split()


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time per call of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fn, args_sets):
    """A call that walks ``args_sets`` in turn, one set a call, so that
    repeated launches do not find their last inputs' rows in the L2 cache."""
    state = {"i": 0}

    def call():
        state["i"] += 1
        return fn(*args_sets[state["i"] % len(args_sets)])

    return call


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max relative error over the entries that are not the -inf sentinel."""
    got, want = got.float(), want.float()
    live = want.abs() < 1e30
    return ((got - want).abs()[live] / want.abs()[live].clamp(min=1e-6)).max().item()


def bound_ms(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_times(prof) -> list[tuple[str, float]]:
    """(name, device us) of every kernel and copy that ran on the card in a
    profiled window, largest first. Only the device events count: a CPU
    op's self device time repeats the time of the kernels it launched."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type == cuda), key=lambda kv: -kv[1])


# profiled_window's windows, those refused, the kernels of earlier windows
# left out, and kernel_device_ms's readings taken by stream_device_ms instead
PROFILER = {"windows": 0, "short": 0, "late_events": 0, "fallbacks": 0}


def profiled_window(fn, iters: int, accept, tries: int = 3) -> list | None:
    """The device events of ``iters`` calls of ``fn`` that started within a
    profiled window's host span, from the first of ``tries`` windows whose
    events ``accept`` takes (given them and all the window's device events);
    None when none does. A window can hand over kernels of the window
    before it and lose some of its own (on an H100: 5 or 7 of 8 launches of
    one kernel; late in this script, 31 of the teacher chunk's 457 device
    events in most windows). PROFILER counts the windows, the events left
    out of their spans and the windows refused."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        host = [e.time_range for e in events if e.device_type != cuda]
        t0, t1 = min(r.start for r in host), max(r.end for r in host)
        device = [e for e in events if e.device_type == cuda]
        mine = [e for e in device if t0 <= e.time_range.start <= t1]
        PROFILER["windows"] += 1
        PROFILER["late_events"] += len(device) - len(mine)
        if accept(mine, device):
            return mine
        PROFILER["short"] += 1
    return None


def kernel_device_ms(fn, name_part: str, iters: int = 16,
                     fallback: bool = True) -> float | None:
    """Device time per call of the kernels whose name holds ``name_part``,
    from torch.profiler: what a launch takes on the card when the wrapper's
    host time exceeds it (CUDA events then read the host's pace). A window
    counts only when those kernels are a multiple of ``iters``
    (profiled_window); after three that are not, the call's whole device
    time from stream_device_ms, every kernel of it counted (None without
    ``fallback``)."""
    def hits(events):
        return [e for e in events if name_part in e.name]

    mine = profiled_window(fn, iters, lambda ev, _: len(hits(ev)) > 0
                           and len(hits(ev)) % iters == 0)
    if mine is not None:
        return sum(e.time_range.elapsed_us() for e in hits(mine)) / 1e3 / iters
    if not fallback:
        return None
    PROFILER["fallbacks"] += 1
    return stream_device_ms(fn, iters)


def stream_device_ms(fn, iters: int = 16) -> float | None:
    """Device time per call of all that ``fn`` launches, from CUDA events,
    without the profiler: a sleep kernel holds the stream until every launch
    of the ``iters`` calls is queued, so the events time them back to back
    on the card, whatever the host's pace. None when ``fn`` waits for the
    card (the sleep had ended before the last launch was queued)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(STREAM_HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()  # the sleep still ran when the last launch was queued
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if held else None


def checked_device_times(fn, name_part: str,
                         per_call: int) -> tuple[list[tuple[str, float]] | None, list]:
    """(name, device ms) of every kernel one call of ``fn`` runs, largest
    first, from a profiled window that holds exactly ``per_call`` kernels
    whose name holds ``name_part`` (profiled_window, up to ten windows), or
    None when none does; and what each window held: [those kernels, its
    device events, the device events outside its span]."""
    seen = []

    def accept(events, device):
        seen.append([sum(name_part in e.name for e in events), len(events),
                     len(device) - len(events)])
        return seen[-1][0] == per_call

    mine = profiled_window(fn, 1, accept, tries=10)
    if mine is None:
        return None, seen
    by_name: dict[str, float] = {}
    for e in mine:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sorted(by_name.items(), key=lambda kv: -kv[1]), seen


def unit_rows(n: int, d: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(n, d, device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from sskd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    summary = {}
    for name, lib in sorted(libs.items()):
        kernel = None
        for line in lib.ptxas_log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:  # after the spill line of the same kernel: keep what it set
                smem = re.search(r"(\d+) bytes smem", line)  # static only; absent when 0
                summary.setdefault(name, {}).setdefault(kernel, {}).update(
                    registers=int(m.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and kernel:
                summary.setdefault(name, {}).setdefault(kernel, {})["spill_bytes"] = (
                    int(m.group(1)) + int(m.group(2))
                )
        for kernel, info in summary.get(name, {}).items():
            log(f"[build] {name}: {kernel}: {info}")
    return summary


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def same_topk(kv, ki, pv, pi, tol: float) -> bool:
    """Equal id sets per row, ties aside: an id in one set only must score
    within ``tol`` of that row's k-th score."""
    check(torch.allclose(kv, pv, rtol=tol, atol=tol), "top-k scores differ")
    for r in range(ki.shape[0]):
        a, b = set(ki[r].tolist()), set(pi[r].tolist())
        if a != b:
            kth = pv[r, -1].item()
            for i in a ^ b:
                row = (ki[r] == i).nonzero() if i in a else (pi[r] == i).nonzero()
                v = (kv if i in a else pv)[r, row[0, 0]].item()
                if abs(v - kth) > tol:
                    return False
    return True


# the route each storage type takes in binmax, binmax_strided and bin_gather at 384
# dims (packed int4 rows of 192 bytes on the tensor cores in all three, bf16 rows on
# the tensor cores in the gather)
TOPK_ROUTES = {
    kernel: {"int8": "tc", "f32": "f32_tc" if kernel == "bin_gather" else "cuda_core",
             "int4": "tc", "bf16": "bf16_tc" if kernel == "bin_gather" else "bf16"}
    for kernel in ("binmax", "binmax_strided", "bin_gather")
}
# the kernel each bin_gather route launches
GATHER_KERNEL = {"tc": "bin_gather_tc_kernel", "bf16_tc": "bin_gather_bf16_tc_kernel",
                 "f32_tc": "bin_gather_f32_tc_kernel", "bf16": "bin_gather_kernel",
                 "cuda_core": "bin_gather_kernel"}


def routed(wrapper, route: str, fn):
    """Run ``fn`` and check that it launched ``wrapper`` once, on ``route``
    (its tc_launches / bf16_launches / f32_tc_launches counters: "bf16_tc"
    counts in the first two, "f32_tc" in the first and the last); returns
    what ``fn`` returns."""
    def counts():
        return (wrapper.launches, wrapper.tc_launches, wrapper.bf16_launches,
                getattr(wrapper, "f32_tc_launches", 0))
    before = counts()
    out = fn()
    want = (before[0] + 1, before[1] + (route in ("tc", "bf16_tc", "f32_tc")),
            before[2] + (route in ("bf16", "bf16_tc")), before[3] + (route == "f32_tc"))
    check(counts() == want, f"{wrapper.__name__}: the launch did not take the {route} route")
    return out


def phase_topk(gen, n_rows: int, dim: int = 384) -> tuple[list, dict, dict, dict]:
    """The top-k kernels against their plain versions over seeded unit rows;
    returns (rows, the main-path entries by name, the bf16 entries by name,
    the int4 entries by name): each kernel at int8 B = 16 (k = 10), each bf16
    route at B = 16, and binmax and binmax_strided over int4 at B = 16."""
    from sskd_tpu_torch.ops import topk_kernels as tk
    from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4, unpack_int4
    from sskd_tpu_torch.ops.topk import approx_blocks, approx_min_bins, cosine_topk_core

    x = unit_rows(n_rows, dim, gen)
    valid_n = n_rows
    rows, main, bf16, int4 = [], {}, {}, {}
    # the cases added after the phases' seeded draws were fixed take theirs from a
    # generator of their own, so that every later phase keeps its inputs
    extra = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 1)
    l2_flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for dtype in ("int8", "f32", "int4", "bf16"):
        if dtype == "f32":
            corpus, scales = x, None
        elif dtype == "bf16":
            corpus, scales = x.to(torch.bfloat16), None
            widened = corpus.float()  # the same rows for the f32 route's yardstick
        else:
            corpus, scales = (quantize_rows if dtype == "int8" else quantize_rows_int4)(x)
        row_bytes = corpus.shape[1] * corpus.element_size()
        op_kind = "int8" if dtype in ("int8", "int4") else "f32"
        want_route = {kernel: routes[dtype] for kernel, routes in TOPK_ROUTES.items()}
        if dtype == "int4":  # the same rows unpacked, for the yardstick over int8 rows
            unpacked = unpack_int4(corpus)
        for B in {"int8": (1, 16, 32, 64, 256), "f32": (1, 16, 64, 256)}.get(dtype,
                                                                            (1, 16, 64, 256)):
            q = unit_rows(B, dim, extra if (dtype, B) in (("int4", 64), ("f32", 64)) else gen)
            q_in, q_scale = tk.quantize_queries(q, corpus)
            route = tk.binmax_route(corpus.dtype, row_bytes)
            check(route == want_route["binmax"], f"binmax {dtype}: route {route}")
            got = routed(tk.binmax, route, lambda: tk.binmax(q_in, corpus, scales, valid_n))
            want = tk.binmax_plain(q_in, corpus, scales, valid_n)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 0.0 if op_kind == "int8" else 1e-5
            check(err <= tol and (op_kind != "int8" or torch.equal(got, want)),
                  f"binmax {dtype} B={B}: max abs err {err} > {tol}")
            n_bins = got.shape[0]
            ms = time_ms(lambda: tk.binmax(q_in, corpus, scales, valid_n), 20)
            plain_ms = time_ms(lambda: tk.binmax_plain(q_in, corpus, scales, valid_n), 3, 1)
            library_ms, yardsticks = None, {}
            if dtype == "f32":
                def lib_fn():
                    return (corpus @ q_in.T)[: (n_rows // 128) * 128].view(-1, 128, B).amax(1)
                library_ms = time_ms(lib_fn, 5)
            elif dtype == "bf16":
                # no library call computes bf16 rows against an f32 query: cuBLAS's bf16
                # product rounds the query to bf16 (a looser function), and the f32
                # route over the widened rows moves twice the bytes; neither is this one
                def cublas_bf16():
                    s = corpus @ q_in.to(torch.bfloat16).T
                    return s[: (n_rows // 128) * 128].float().view(-1, 128, B).amax(1)
                yardsticks = {
                    "yardstick_cublas_bf16_query_rounded_ms": time_ms(cublas_bf16, 5),
                    "yardstick_f32_route_widened_rows_ms": time_ms(
                        lambda: tk.binmax(q_in, widened, None, valid_n), 10),
                }
            elif dtype == "int8" and B % 8 == 0:
                def lib_fn():
                    s = torch._int_mm(corpus, q_in.T).float() * scales[:, None]
                    return s[: (n_rows // 128) * 128].view(-1, 128, B).amax(1)
                library_ms = time_ms(lib_fn, 5)
            elif dtype == "int4" and B % 8 == 0:
                # no library call takes packed rows: cuBLAS's int8 product after
                # unpacking (the unpack timed), and over a copy unpacked beforehand
                def int_mm_bins(rows_i8):
                    s = torch._int_mm(rows_i8, q_in.T).float() * scales[:, None]
                    return s[: (n_rows // 128) * 128].view(-1, 128, B).amax(1)
                yardsticks = {
                    "yardstick_int_mm_unpack_included_ms": time_ms(
                        lambda: int_mm_bins(unpack_int4(corpus)), 5),
                    "yardstick_int_mm_unpacked_rows_ms": time_ms(
                        lambda: int_mm_bins(unpacked), 5),
                }
            n_bytes = (n_rows * row_bytes + n_rows * 4 * (scales is not None)
                       + q_in.numel() * q_in.element_size() + n_bins * B * 4)
            b_ms, b_by = bound_ms(n_bytes, 2.0 * B * n_rows * dim, op_kind)
            name = ("binmax_tc_kernel" if route == "tc"
                    else "binmax_f32_kernel" if dtype in ("f32", "bf16") else "binmax_kernel")
            entry = {
                "kernel": "binmax", "dtype": dtype, "B": B, "N": n_rows, "D": dim,
                "route": route, "max_abs_err": err, "max_rel_err": rel_err(got, want), "ms": ms,
                "kernel_device_ms": kernel_device_ms(
                    lambda: tk.binmax(q_in, corpus, scales, valid_n), name, 8),
                # the same launches, each after the L2 cache was overwritten: what
                # the byte bound assumes (the overwrite's own kernel is not counted)
                "kernel_device_ms_cold_l2": kernel_device_ms(
                    lambda: (l2_flush.zero_(), tk.binmax(q_in, corpus, scales, valid_n)),
                    name, 8, fallback=False),
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, **yardsticks,
            }
            rows.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
            if B == 16 and dtype == "int8":
                main["binmax"] = entry
            if B == 16 and dtype == "bf16":
                bf16["binmax"] = entry
            if B == 16 and dtype == "int4":
                int4["binmax"] = entry
            # the approx engine's pass at the blocks it takes for k = 10 at 0.99
            groups = math.ceil(approx_min_bins(10, 0.99) / 128)
            blocks = approx_blocks(B, groups, n_bins)
            # the count the engine takes at the other side of its batch rule
            alt_blocks = approx_blocks(256 if B <= 64 else 1, groups, n_bins)
            s_route = tk.binmax_strided_route(corpus.dtype, row_bytes)
            check(s_route == want_route["binmax_strided"],
                  f"binmax_strided {dtype}: route {s_route}")
            s_got, s_rows = routed(tk.binmax_strided, s_route, lambda: tk.binmax_strided(
                q_in, corpus, scales, valid_n, blocks))
            s_want, s_want_rows = tk.binmax_strided_plain(q_in, corpus, scales, valid_n, blocks)
            torch.cuda.synchronize()
            s_err = (s_got - s_want).abs().max().item()
            rows_same = (s_rows == s_want_rows).float().mean().item()
            # f32, bf16: summation order can move a near-tie inside a bin
            check(s_err <= tol and (torch.equal(s_got, s_want) and rows_same == 1.0
                                    if op_kind == "int8" else rows_same >= 0.9999),
                  f"binmax_strided {dtype} B={B}: max abs err {s_err}, "
                  f"{1 - rows_same:.2e} of the rows differ")
            s_ms = time_ms(lambda: tk.binmax_strided(q_in, corpus, scales, valid_n, blocks), 20)
            s_name = ("binmax_strided_tc_kernel" if s_route == "tc"
                      else "binmax_strided_f32_kernel" if op_kind == "f32"
                      else "binmax_strided_kernel")
            s_dev = kernel_device_ms(
                lambda: tk.binmax_strided(q_in, corpus, scales, valid_n, blocks), s_name, 8)
            s_cold = kernel_device_ms(  # each launch after the L2 cache was overwritten
                lambda: (l2_flush.zero_(),
                         tk.binmax_strided(q_in, corpus, scales, valid_n, blocks)),
                s_name, 8, fallback=False) if dtype == "int4" else None
            alt_ms = time_ms(
                lambda: tk.binmax_strided(q_in, corpus, scales, valid_n, alt_blocks), 20)
            # the pass at other multiples of the groups, for approx_blocks (int8)
            sweep = {}
            if dtype == "int8":
                for cand in (groups * 19, groups * 38, groups * 75, groups * 150, groups * 300):
                    sweep[str(cand)] = time_ms(
                        lambda: tk.binmax_strided(q_in, corpus, scales, valid_n, cand), 10)
            s_plain = time_ms(
                lambda: tk.binmax_strided_plain(q_in, corpus, scales, valid_n, blocks), 3, 1)
            s_library, s_yard = None, {}
            if dtype in ("f32", "bf16") or (dtype in ("int8", "int4") and B % 8 == 0):
                span = blocks * 128
                rounds = -(-n_rows // span)

                def strided_lib(rows_i8=None):
                    if dtype == "bf16":  # the query rounded: a looser function (above)
                        sc = (corpus @ q_in.to(torch.bfloat16).T).float()
                    elif dtype == "f32":
                        sc = corpus @ q_in.T
                    elif dtype == "int4":  # no library call takes packed rows (above)
                        rows_i8 = unpack_int4(corpus) if rows_i8 is None else rows_i8
                        sc = torch._int_mm(rows_i8, q_in.T).float() * scales[:, None]
                    else:
                        sc = torch._int_mm(corpus, q_in.T).float() * scales[:, None]
                    sc = F.pad(sc, (0, 0, 0, rounds * span - n_rows), value=tk.NEG_INF)
                    return sc.view(rounds, span, B).max(dim=0)
                if dtype == "bf16":
                    s_yard = {
                        "yardstick_cublas_bf16_query_rounded_ms": time_ms(strided_lib, 5),
                        "yardstick_f32_route_widened_rows_ms": time_ms(
                            lambda: tk.binmax_strided(q_in, widened, None, valid_n, blocks), 10),
                    }
                elif dtype == "int4":
                    s_yard = {
                        "yardstick_int_mm_unpack_included_ms": time_ms(strided_lib, 5),
                        "yardstick_int_mm_unpacked_rows_ms": time_ms(
                            lambda: strided_lib(unpacked), 5),
                    }
                else:
                    s_library = time_ms(strided_lib, 5)
            sb_ms, sb_by = bound_ms(n_bytes - n_bins * B * 4 + blocks * 128 * B * 8,
                                    2.0 * B * n_rows * dim, op_kind)
            s_entry = {
                "kernel": "binmax_strided", "dtype": dtype, "B": B, "N": n_rows, "D": dim,
                "blocks": blocks, "max_abs_err": s_err, "max_rel_err": rel_err(s_got, s_want),
                "rows_equal_share": rows_same, "route": s_route, "ms": s_ms,
                "kernel_device_ms": s_dev, "kernel_device_ms_cold_l2": s_cold,
                "plain_ms": s_plain,
                "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": s_library, **s_yard,
                "alt_blocks": alt_blocks, "alt_blocks_ms": alt_ms, "blocks_ms": sweep,
            }
            rows.append(s_entry)
            log(f"[kernels] {json.dumps(s_entry)}")
            if B == 16 and dtype == "int8":
                main["binmax_strided"] = s_entry
            if B == 16 and dtype == "bf16":
                bf16["binmax_strided"] = s_entry
            if B == 16 and dtype == "int4":
                int4["binmax_strided"] = s_entry
            del s_got, s_rows, s_want, s_want_rows
            for k in (10, 40) if dtype == "bf16" else (10, 100):
                kb = min(k, n_bins)
                _, bins = tk.topk_stable(want.T, kb)
                bins = bins.to(torch.int32).contiguous()
                g_route = tk.bin_gather_route(corpus.dtype, row_bytes)
                check(g_route == want_route["bin_gather"], f"bin_gather {dtype}: route {g_route}")
                g_got = routed(tk.bin_gather, g_route, lambda: tk.bin_gather(
                    q_in, q_scale, corpus, scales, bins, valid_n))
                g_want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n)
                torch.cuda.synchronize()
                g_err = (g_got - g_want).abs().max().item()
                check(g_err <= tol and (op_kind != "int8" or torch.equal(g_got, g_want)),
                      f"bin_gather {dtype} B={B} k={k}: err {g_err} > {tol}")
                g_rel = rel_err(g_got, g_want)
                del g_got
                g_call = lambda: tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
                g_ms = time_ms(g_call, 20)
                # the card's own time: the wrapper's host time can exceed it
                g_name = GATHER_KERNEL[g_route]
                g_dev = kernel_device_ms(g_call, g_name)
                g_cold = kernel_device_ms(  # each launch after the L2 cache was overwritten
                    lambda: (l2_flush.zero_(), g_call()), g_name, 8, fallback=False)
                g_plain = time_ms(
                    lambda: tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n),
                    2, 1,
                )
                # bytes: each distinct bin's rows once (queries share bins); the raw
                # bytes, each pair's bins read on their own, bound a layout that does
                # not reuse a bin several queries chose
                cand = B * kb * 128
                rows_read = torch.unique(bins).numel() * 128
                row_in = row_bytes + 4 * (scales is not None)
                rest = cand * 4 + bins.numel() * 4 + q_in.numel() * q_in.element_size()
                gb_ms, gb_by = bound_ms(rows_read * row_in + rest, 2.0 * cand * dim, op_kind)
                raw_ms, _ = bound_ms(cand * row_in + rest, 2.0 * cand * dim, op_kind)
                # the yardstick: index_select of the chosen rows and bmm with the query
                # (int4: over the rows unpacked in the call and beforehand)
                pick = (bins.long()[:, :, None] * 128
                        + torch.arange(128, device="cuda")).view(-1).clamp(max=n_rows - 1)

                def gather_bmm(src, unpack=False):
                    picked = src.index_select(0, pick)
                    picked = unpack_int4(picked) if unpack else picked
                    sc = torch.bmm(picked.float().view(B, kb * 128, dim),
                                   q_in.float()[:, :, None])[:, :, 0]
                    if scales is not None:
                        sc = sc * scales[pick].view(B, -1)
                    return sc * q_scale[:, None] if q_scale is not None else sc
                if dtype == "int4":
                    yard = {"yardstick_index_select_bmm_unpack_included_ms": time_ms(
                                lambda: gather_bmm(corpus, True), 10),
                            "yardstick_index_select_bmm_unpacked_rows_ms": time_ms(
                                lambda: gather_bmm(unpacked), 10)}
                else:
                    yard = {"yardstick_index_select_bmm_ms": time_ms(
                        lambda: gather_bmm(corpus), 10)}
                # the whole engine against the blocked plain engine
                kv, ki = tk.cosine_topk_kernels(q, corpus, k, row_scales=scales, valid_n=valid_n)
                pv, pi = cosine_topk_core(q, corpus, k, row_scales=scales, valid_n=valid_n)
                check(same_topk(kv, ki, pv, pi, 1e-5), f"engine {dtype} B={B} k={k}: ids differ")
                e_ms = time_ms(
                    lambda: tk.cosine_topk_kernels(q, corpus, k, row_scales=scales,
                                                   valid_n=valid_n), 10
                )
                e_plain = time_ms(
                    lambda: cosine_topk_core(q, corpus, k, row_scales=scales, valid_n=valid_n),
                    2, 1,
                )
                g_entry = {
                    "kernel": "bin_gather", "dtype": dtype, "B": B, "k": k, "kb": kb,
                    "route": g_route,
                    "max_abs_err": g_err, "max_rel_err": g_rel,
                    "ms": g_ms, "kernel_device_ms": g_dev, "kernel_device_ms_cold_l2": g_cold,
                    "plain_ms": g_plain, "bound_ms": gb_ms, "bound_by": gb_by,
                    "bound_raw_bytes_ms": raw_ms, "distinct_bins": rows_read // 128,
                    "library_ms": None, **yard,
                    "engine_ms": e_ms, "plain_engine_ms": e_plain,
                }
                if dtype == "f32":  # both layouts of the f32 kernel, the sort, three TF32 passes
                    g_entry.update(f32_gather_layouts(q_in, corpus, bins, valid_n))
                    g_entry["three_pass_ms"] = 3 * 2.0 * cand * dim / PEAK_OPS["tf32"] * 1e3
                if dtype in ("int4", "bf16", "f32"):
                    # the CUDA-core kernel these rows took before, on the same inputs
                    old_call = lambda: bin_gather_cuda_cores(
                        q_in, q_scale, corpus, scales, bins, valid_n)
                    old = old_call()
                    torch.cuda.synchronize()
                    old_err = (old - g_want).abs().max().item()
                    check(old_err <= tol and (op_kind != "int8" or torch.equal(old, g_want)),
                          f"bin_gather_kernel {dtype} B={B} k={k}: err {old_err} > {tol}")
                    del old
                    g_entry.update({
                        "cuda_core_kernel_max_abs_err": old_err,
                        "cuda_core_kernel_device_ms": kernel_device_ms(
                            old_call, "bin_gather_kernel"),
                        "cuda_core_kernel_device_ms_cold_l2": kernel_device_ms(
                            lambda: (l2_flush.zero_(), old_call()), "bin_gather_kernel", 8,
                            fallback=False),
                    })
                if dtype == "bf16":  # the same bins over the widened rows: twice the bytes
                    g_entry["yardstick_f32_route_widened_rows_device_ms"] = kernel_device_ms(
                        lambda: tk.bin_gather(q_in, None, widened, None, bins, valid_n),
                        "bin_gather_kernel")
                rows.append(g_entry)
                log(f"[kernels] {json.dumps(g_entry)}")
                if B == 16 and k == 10 and dtype == "int8":
                    main["bin_gather"] = g_entry
                if B == 16 and k == 10 and dtype == "bf16":
                    bf16["bin_gather"] = g_entry
                if B == 16 and k == 10 and dtype == "int4":
                    int4["bin_gather"] = g_entry
                if B == 16 and k == 10 and dtype == "f32":
                    main["bin_gather.f32.search"] = g_entry
        if dtype == "int8":
            rows += gather_order_cases(gen, x, corpus, scales)
            rows.append(wrapper_host_us(gen, corpus, scales))
        if dtype == "int4":
            del unpacked
        del corpus, scales
    del widened, x
    rows += dp4a_cases(extra, n_rows, l2_flush)
    return rows, main, bf16, int4


def f32_gather_layouts(q_in, corpus, bins, valid_n) -> dict:
    """bin_gather's f32 tensor-core kernel (bin_gather_f32_tc_kernel) in both
    of its layouts through its C entry on the same inputs: the pairs in their
    own order and sorted by bin (bin_order, the sort apart), each bit for bit
    the wrapper's result; their device times behind a held stream, the
    sort's, and the layout the wrapper takes (bin_gather_f32_layout)."""
    from sskd_tpu_torch.ops import _build
    from sskd_tpu_torch.ops import topk_kernels as tk

    B, kb = bins.shape
    n = corpus.shape[0]
    fn = tk._fn("bin_gather", "sskd_bin_gather_f32_tc")
    want = tk.bin_gather(q_in, None, corpus, None, bins, valid_n)
    order = tk.bin_order(bins, n)
    got = torch.empty((B, kb, 128), dtype=torch.float32, device="cuda")

    def layout(sort):
        _build.check(fn(tk._ptr(q_in), tk._ptr(corpus), None, tk._ptr(bins),
                        tk._ptr(order if sort else None), tk._ptr(got), B, kb, n,
                        corpus.shape[1], valid_n, tk._stream(corpus.device)),
                     "bin_gather (f32, one layout)")
        return got
    out = {"f32_layout": tk.bin_gather_f32_layout(B * kb, n)}
    for name, sort in (("own", False), ("sorted", True)):
        layout(sort)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bin_gather f32 {name} layout B={B} kb={kb}: not the "
              "wrapper's bits")
        out[f"f32_{name}_layout_device_ms"] = stream_device_ms(lambda s=sort: layout(s), 20)
    out["f32_sort_device_ms"] = stream_device_ms(lambda: tk.bin_order(bins, n), 20)
    return out


def dp4a_cases(gen, n_rows: int, l2_flush, dim: int = 1056) -> list:
    """The CUDA-core kernels that the 384-dim cases no longer reach, bit for
    bit against the plain versions, with the L2 cache cold and warm: binmax,
    binmax_strided and bin_gather on their dp4a kernels (binmax_kernel,
    binmax_strided_kernel, bin_gather_kernel) over packed int4 rows of dim /
    2 = 528 bytes, over the 512 the tensor-core routes take, at B in {1, 16,
    256} (the gather at k = 10 over the bins binmax chose); then
    bin_gather_kernel's bf16 mode over rows of 1,056 bytes (long_bf16_gather)."""
    from sskd_tpu_torch.ops import topk_kernels as tk
    from sskd_tpu_torch.ops.quant import quantize_rows_int4
    from sskd_tpu_torch.ops.topk import approx_blocks, approx_min_bins

    corpus, scales = quantize_rows_int4(unit_rows(n_rows, dim, gen))
    row_bytes = corpus.shape[1]
    n_bins = -(-n_rows // 128)
    groups = math.ceil(approx_min_bins(10, 0.99) / 128)
    out = []
    for B in (1, 16, 256):
        q_in, q_scale = tk.quantize_queries(unit_rows(B, dim, gen), corpus)
        blocks = approx_blocks(B, groups, n_bins)
        bins = None
        for kernel, wrapper, route_fn, plain, name, more, out_bytes in (
                ("binmax", tk.binmax, tk.binmax_route, tk.binmax_plain, "binmax_kernel",
                 (), n_bins * B * 4),
                ("binmax_strided", tk.binmax_strided, tk.binmax_strided_route,
                 tk.binmax_strided_plain, "binmax_strided_kernel", (blocks,),
                 blocks * 128 * B * 8)):
            route = route_fn(corpus.dtype, row_bytes)
            check(route == "cuda_core", f"{kernel} int4 D={dim}: route {route}")
            call = lambda w=wrapper, a=more: w(q_in, corpus, scales, n_rows, *a)
            got = routed(wrapper, route, call)
            want = plain(q_in, corpus, scales, n_rows, *more)
            if kernel == "binmax":  # binmax gives the maxima, binmax_strided (maxima, rows)
                bins = tk.topk_stable(want.T, 10)[1].to(torch.int32).contiguous()
                got, want = (got,), (want,)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{kernel} int4 D={dim} B={B}: not bit for bit the plain version")
            err = (got[0] - want[0]).abs().max().item()
            del got, want
            b_ms, b_by = bound_ms(n_rows * (row_bytes + 4) + q_in.numel() + out_bytes,
                                  2.0 * B * n_rows * dim, "int8")
            entry = {
                "kernel": kernel, "dtype": "int4", "B": B, "N": n_rows, "D": dim,
                "blocks": blocks if kernel == "binmax_strided" else None,
                "route": route, "max_abs_err": err, "ms": time_ms(call, 10),
                "kernel_device_ms": kernel_device_ms(call, name, 8),
                "kernel_device_ms_cold_l2": kernel_device_ms(
                    lambda c=call: (l2_flush.zero_(), c()), name, 8, fallback=False),
                "plain_ms": time_ms(lambda p=plain, a=more: p(
                    q_in, corpus, scales, n_rows, *a), 2, 1),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
            out.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
        out.append(cuda_core_gather_case(q_in, q_scale, corpus, scales, bins, "int4", dim,
                                         l2_flush))
    del corpus, scales
    out.append(long_bf16_gather(gen, l2_flush))
    return out


def cuda_core_gather_case(q_in, q_scale, corpus, scales, bins, dtype, dim, l2_flush) -> dict:
    """bin_gather on bin_gather_kernel (the "cuda_core" route for int4, "bf16"
    for bf16) over rows past the tensor-core routes: int4 bit for bit with
    the plain version, bf16 within 1e-5; warm and cold device times."""
    from sskd_tpu_torch.ops import topk_kernels as tk

    n_rows, row_bytes = corpus.shape[0], corpus.shape[1] * corpus.element_size()
    B, kb = bins.shape
    route = tk.bin_gather_route(corpus.dtype, row_bytes)
    check(route == ("bf16" if dtype == "bf16" else "cuda_core"),
          f"bin_gather {dtype} D={dim}: route {route}")
    call = lambda: tk.bin_gather(q_in, q_scale, corpus, scales, bins, n_rows)
    got = routed(tk.bin_gather, route, call)
    want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, n_rows)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.equal(got, want) if dtype == "int4" else err <= 1e-5,
          f"bin_gather {dtype} D={dim} B={B}: err {err} against the plain version")
    del got, want
    cand = B * kb * 128
    row_in = row_bytes + 4 * (scales is not None)
    b_ms, b_by = bound_ms(torch.unique(bins).numel() * 128 * row_in + cand * 4
                          + bins.numel() * 4 + q_in.numel() * q_in.element_size(),
                          2.0 * cand * dim, "int8" if dtype == "int4" else "f32")
    entry = {
        "kernel": "bin_gather", "dtype": dtype, "B": B, "N": n_rows, "D": dim, "kb": kb,
        "route": route, "max_abs_err": err, "ms": time_ms(call, 20),
        "kernel_device_ms": kernel_device_ms(call, "bin_gather_kernel", 8),
        "kernel_device_ms_cold_l2": kernel_device_ms(
            lambda: (l2_flush.zero_(), call()), "bin_gather_kernel", 8, fallback=False),
        "plain_ms": time_ms(lambda: tk.bin_gather_plain(
            q_in, q_scale, corpus, scales, bins, n_rows), 2, 1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    log(f"[kernels] {json.dumps(entry)}")
    return entry


def long_bf16_gather(gen, l2_flush, n_rows: int = 100_000, dim: int = 528) -> dict:
    """bin_gather over bf16 rows of 1,056 bytes, past the 1,024 that its
    tensor-core kernel takes: bin_gather_kernel's bf16 mode at B = 16, k =
    10 over the bins the plain binmax chose."""
    from sskd_tpu_torch.ops import topk_kernels as tk

    corpus = unit_rows(n_rows, dim, gen).to(torch.bfloat16)
    q = unit_rows(16, dim, gen)
    bins = tk.topk_stable(tk.binmax_plain(q, corpus, None, n_rows).T, 10)[1]
    return cuda_core_gather_case(q, None, corpus, None, bins.to(torch.int32).contiguous(),
                                 "bf16", dim, l2_flush)


def gather_order_cases(gen, x, corpus, scales) -> list:
    """bin_gather's tensor-core route with the (query, slot) pairs in their
    own order, one a block (what the wrapper passes), and sorted by bin in
    runs of two moved to bin boundaries (each distinct bin read once, at the
    price of a sort), on corpus-derived queries at B = 16
    and 64, also as a padded batch whose last three quarters repeat one
    query. Device time from the profiler, and CUDA events around the whole
    call with the sort."""
    from sskd_tpu_torch.ops import _build
    from sskd_tpu_torch.ops import topk_kernels as tk

    n = corpus.shape[0]
    fn = tk._fn("bin_gather", "sskd_bin_gather_tc")
    out = []

    def gather(q_in, q_scale, bins, sort):
        B, kb = bins.shape
        o = torch.empty((B, kb, 128), dtype=torch.float32, device="cuda")
        cells, order = torch.sort(bins.view(-1), stable=True) if sort else (bins, None)
        _build.check(fn(1, tk._ptr(q_in), tk._ptr(q_scale), tk._ptr(corpus), tk._ptr(scales),
                        tk._ptr(cells), tk._ptr(order), tk._ptr(o), B, kb, n,
                        corpus.shape[1], n, 2 if sort else tk.GATHER_TC_RUN,
                        tk._stream(corpus.device)),
                     "bin_gather (tensor cores, sorted)")
        return o

    for B in (16, 64):
        for padded in (False, True):
            src = torch.randint(0, n, (B,), device="cuda", generator=gen)
            q = x[src] + 0.05 * torch.randn(B, x.shape[1], device="cuda", generator=gen)
            if padded:
                q[B // 4:] = q[0]
            q = q / q.norm(dim=1, keepdim=True)
            q_in, q_scale = tk.quantize_queries(q, corpus)
            _, bins = tk.topk_stable(tk.binmax(q_in, corpus, scales, n).T, 10)
            bins = bins.to(torch.int32).contiguous()
            want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, n)
            entry = {"kernel": "bin_gather_order", "B": B, "kb": 10, "padded": padded,
                     "distinct_bins": torch.unique(bins).numel()}
            for name, sort in (("own_order", False), ("sorted", True)):
                got = gather(q_in, q_scale, bins, sort)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"bin_gather {name} B={B}: differs from plain")
                entry[name + "_ms"] = time_ms(lambda: gather(q_in, q_scale, bins, sort), 50)
                entry[name + "_device_ms"] = kernel_device_ms(  # the gather without the sort
                    lambda: gather(q_in, q_scale, bins, sort), "bin_gather_tc_kernel", 30,
                    fallback=False)
            entry["sort_device_ms"] = kernel_device_ms(
                lambda: torch.sort(bins.view(-1), stable=True), "", 30)
            log(f"[kernels] {json.dumps(entry)}")
            out.append(entry)
    return out


def bin_gather_cuda_cores(q_in, q_scale, corpus, scales, bins, valid_n):
    """bin_gather_kernel launched through its C entry (sskd_bin_gather) on
    rows that the wrapper sends to a tensor-core kernel: the kernel those
    rows took before, for its time beside its successor's on the same
    inputs. Returns the scores [B, kb, 128]."""
    from sskd_tpu_torch.ops import _build
    from sskd_tpu_torch.ops import topk_kernels as tk

    B, kb = bins.shape
    mode = tk._mode(corpus)
    out = torch.empty((B, kb, 128), dtype=torch.float32, device="cuda")
    _build.check(tk._fn("bin_gather", "sskd_bin_gather")(
        mode, tk._ptr(q_in), tk._ptr(q_scale if mode in tk._QUANTIZED else None),
        tk._ptr(corpus), tk._ptr(scales), tk._ptr(bins), tk._ptr(out), B, kb, corpus.shape[0],
        corpus.shape[1] * corpus.element_size() // 4, valid_n, tk._stream(corpus.device)),
        "bin_gather (CUDA cores)")
    return out


def wrapper_host_us(gen, corpus, scales, calls: int = 2000) -> dict:
    """Host microseconds per call of the bin_gather wrapper at int8 B = 16,
    kb = 10 (no synchronisation inside the loop), and of its parts."""
    from sskd_tpu_torch.ops import topk_kernels as tk

    n = corpus.shape[0]
    q_in, q_scale = tk.quantize_queries(unit_rows(16, corpus.shape[1], gen), corpus)
    bins = torch.randint(0, n // 128, (16, 10), device="cuda", dtype=torch.int32,
                         generator=gen)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        el = time.perf_counter() - t0
        torch.cuda.synchronize()
        return el / calls * 1e6

    parts = {
        "wrapper": lambda: tk.bin_gather(q_in, q_scale, corpus, scales, bins, n),
        "check_operands": lambda: tk._check_operands(q_in, corpus, scales, n),
        "check_cuda": lambda: tk._check_cuda(q_in, corpus, scales, bins, q_scale),
        "torch_empty": lambda: torch.empty((16, 10, 128), dtype=torch.float32,
                                           device=corpus.device),
        "stream": lambda: tk._stream(corpus.device),
        "ptr_x7": lambda: [tk._ptr(t) for t in (q_in, q_scale, corpus, scales, bins, None, q_in)],
        # what the wrapper built in their place before it passed ints and the raw stream
        "stream_object": lambda: ctypes.c_void_p(torch.cuda.current_stream(corpus.device).cuda_stream),
        "ptr_ctypes_x7": lambda: [ctypes.c_void_p(t.data_ptr() if t is not None else 0)
                                  for t in (q_in, q_scale, corpus, scales, bins, None, q_in)],
    }
    entry = {"kernel": "bin_gather_host_us", "B": 16, "kb": 10,
             **{name: host_us(fn) for name, fn in parts.items()}}
    log(f"[kernels] {json.dumps(entry)}")
    return entry


def phase_flash(gen) -> tuple[list, dict]:
    from sskd_tpu_torch.ops import attention as ta

    B, h, d = 256, 12, 32
    rows, main = [], None
    for L in (512, 256, 128):
        q, k, v = (torch.randn(B, h, L, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.randint(L // 8, L + 1, (B,), device="cuda", generator=gen)
        lens[0] = L
        mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        before = ta.flash_attention.tc_launches
        got = ta.flash_attention(q, k, v, mask)
        want = ta.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        check(ta.flash_attention.tc_launches == before + 1,
              f"flash_attn_fwd bf16 L={L} did not take the tensor-core route")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # bf16: per element, the rounding of p and of the output on each side
        # (ta.flash_error_bound derives it)
        slack = (diff / ta.flash_error_bound(q, k, v, mask, got, want)).max().item()
        check(slack <= 1.0, f"flash_attn_fwd L={L}: max abs err {err} is {slack:.3f} "
              "of its bound")
        f32_err = None
        if L == 512:
            # the f32 route on the same inputs (three TF32 products a product,
            # flash_fwd_tc_tf32_kernel<32>): every tile and the masking within
            # 1e-5 of the plain version
            qf, kf, vf = q.float(), k.float(), v.float()
            before = ta.flash_attention.tc_launches
            f32_err = (ta.flash_attention(qf, kf, vf, mask)
                       - ta.flash_attention_plain(qf, kf, vf, mask)).abs().max().item()
            check(ta.flash_attention.tc_launches == before + 1,
                  f"flash_attn_fwd f32 L={L} did not take the tensor-core route")
            check(f32_err <= 1e-5, f"flash_attn_fwd f32 L={L}: max abs err {f32_err} > 1e-5")
            del qf, kf, vf
        ms = time_ms(lambda: ta.flash_attention(q, k, v, mask), 10)
        plain_ms = time_ms(lambda: ta.flash_attention_plain(q, k, v, mask), 3, 1)
        keep = mask[:, None, None, :].bool()
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 10
        )
        # what the encoder runs below FLASH_MIN_L: the crossover a later PR needs
        bias = torch.where(keep, 0.0, ta.NEG_INF)
        plain_attention_ms = time_ms(lambda: ta.plain_attention(q, k, v, bias), 5, 1)
        del bias
        b_ms, b_by = bound_ms(4 * B * h * L * d * 2 + B * L * 4, 4.0 * B * h * L * L * d, "bf16")
        entry = {
            "kernel": "flash_attn_fwd", "dtype": "bf16", "shape": [B, h, L, d],
            "max_abs_err": err, "max_rel_err": rel_err(got, want), "err_over_bound": slack,
            "f32_max_abs_err": f32_err, "route": ta.flash_route(q.dtype, d), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "plain_attention_ms": plain_attention_ms,
            # one exp per score on the special-function unit (16 a clock an SM)
            "exp_floor_ms": B * h * L * L / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3,
        }
        rows.append(entry)
        log(f"[kernels] {json.dumps(entry)}")
        if L == 512:
            main = entry
    return rows, main


def attn_bias(B: int, L: int, gen) -> torch.Tensor:
    """The encoder's additive key bias [B, L] f32: 0 on the first len tokens,
    finfo(bf16).min / 2 on the padding (random lengths, the first row full)."""
    lens = torch.randint(max(1, L // 8), L + 1, (B,), device="cuda", generator=gen)
    lens[0] = L
    keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    return torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min / 2).float()


def masks_spelled_by_kernels(seed: int) -> bool:
    """The keep-masks the two kernels apply, read back bit for bit: q = k = 0
    and a zero bias make every probability 1/256 at L = 256, at p = 0.5 each
    kept one is 1/128 exactly, and v (g) holding 2^(j % 8) in channel j // 8
    makes the f32 output (dv) spell each row's (column's) keep bits."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, d = 2, 12, 256, 32
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda")
    bias = torch.zeros(B, L, device="cuda")
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    bit = torch.arange(8, device="cuda")

    def spell(x):
        n = (x * 128).round().long()
        return ((n[..., None] >> bit) & 1).reshape(B, h, L, L).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    return bool((spell(out) == want).all()) and bool((spell(dv).transpose(-1, -2) == want).all())


def masks_spelled_bf16(seed: int, d: int = 32) -> bool:
    """The same read-back in bf16 at L = 192, the training length the
    tensor-core backward takes: a bias that leaves keys 0..127 live makes each
    live probability 1/128, so at p = 0.5 each kept pd is 1/64 exactly in
    bf16; out spells each row's keep bits over the live columns, and dv each
    live column's over the 192 rows (row i in channel i // 8): the keep bits
    the tensor-core forward drew and applied, and those the tensor-core
    backward stored in pass 1 and applied to pd."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, live = 2, 12, 192, 128
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.to(torch.bfloat16).expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda", dtype=torch.bfloat16)
    bias = torch.where(j < live, 0.0, torch.finfo(torch.bfloat16).min / 2).expand(B, L)
    bias = bias.contiguous()
    before = ta.dropattn_fwd.tc_launches
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    check(ta.dropattn_fwd.tc_launches == before + 1,
          f"bf16 d={d} L=192: not the tensor-core forward")
    before = ta.dropattn_bwd.tc_launches
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    check(ta.dropattn_bwd.tc_launches == before + 1, "bf16 L=192: not the tensor-core backward")
    bit = torch.arange(8, device="cuda")

    def spell(x, n):  # [..., 32] sums of 2^bit / 64 -> [..., n] bits
        c = (x.float() * 64).round().long()[..., : n // 8]
        return ((c[..., None] >> bit) & 1).flatten(-2).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    return (bool((spell(out, live) == want[..., :live]).all())
            and bool((spell(dv[:, :, :live], L) == want[..., :live].transpose(-1, -2)).all()))


def masks_equal(seed: int, BH: int, L: int, p: float) -> bool:
    """The kernels' generator against the plain one over every (head, row, col)."""
    from sskd_tpu_torch.ops import attention as ta

    got = ta.dropattn_keep_mask_kernel(seed, BH, L, p)
    step = max(1, (1 << 26) // (L * L))
    return all(
        bool((got[a:a + step] == (ta.dropout_uniform(seed, a, min(step, BH - a), L, "cuda") >= p))
             .all())
        for a in range(0, BH, step)
    )


def masks_spelled_stream_bf16(seed: int) -> bool:
    """The read-back of masks_spelled_bf16 through the streaming backward at
    L = 512, head dim 32: a bias that leaves keys 0..255 live makes each
    live probability 1/256, each kept pd 1/128 exactly in bf16 at p = 0.5;
    g holding 2^(i % 8) in channel i // 8 for the rows i of one half (two
    launches) makes dv spell each live key's keep bits over all 512 rows:
    the bits the first kernel drew and the third applied."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, d, live = 2, 12, 512, 32, 256
    j = torch.arange(L, device="cuda")
    zero = torch.zeros(B, h, L, d, device="cuda", dtype=torch.bfloat16)
    bias = torch.where(j < live, 0.0, torch.finfo(torch.bfloat16).min / 2).expand(B, L)
    bias = bias.contiguous()
    _, lse = ta.dropattn_fwd(zero, zero, zero, bias, 0.5, seed)
    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    bit = torch.arange(8, device="cuda")
    ok = True
    for half in range(2):
        rows = j - 256 * half
        mine = (rows >= 0) & (rows < 256)
        code = torch.zeros(L, d, device="cuda")
        code[j[mine], rows[mine] // 8] = (2.0 ** (rows[mine] % 8)).float()
        code = code.to(torch.bfloat16).expand(B, h, L, d).contiguous()
        before = ta.dropattn_bwd.stream_launches
        _, _, dv = ta.dropattn_bwd(zero, zero, zero, bias, 0.5, seed, lse, code)
        check(ta.dropattn_bwd.stream_launches == before + 1,
              "bf16 L=512: not the streaming backward")
        c = (dv[:, :, :live].float() * 128).round().long()
        spelled = ((c[..., None] >> bit) & 1).flatten(-2).bool()  # [B, h, live keys, 256 rows]
        ok = ok and bool((spelled == want[:, :, 256 * half:256 * (half + 1), :live]
                          .transpose(-1, -2)).all())
    return ok


def stream_bits_equal(q, k, v, bias, p, seed, lse, g) -> bool:
    """The keep bits the streaming backward's first kernel wrote, through
    its private entry, against the plain mask packed the same way
    (pack_keep_bits), head block by head block."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, _ = q.shape
    bits = ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g)[4]
    step = max(1, (1 << 25) // (L * L))
    return all(torch.equal(bits[a:a + step], ta.pack_keep_bits(
        ta.dropout_uniform(seed, a, min(step, B * h - a), L, "cuda") >= p))
        for a in range(0, B * h, step))


def stream_times(q, k, v, bias, p, seed, lse, g, build: dict, pre: str = "bwd") -> dict:
    """The streaming backward's ms a call (CUDA events), its device time
    summed over its three launches (profiler; kernel_device_ms), and
    ptxas's registers and spills of its kernels at this (dtype, d), keyed
    ``{pre}_ms`` etc. Through the private entry, so it takes any L."""
    from sskd_tpu_torch.ops import attention as ta

    d = q.shape[-1]
    tname = "f" if q.dtype == torch.float32 else "13__nv_bfloat16"
    return {
        f"{pre}_ms": time_ms(lambda: ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g), 10),
        f"{pre}_kernel_device_ms": kernel_device_ms(
            lambda: ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g),
            "dropattn_bwd_stream"),
        f"{pre}_ptxas": ptxas_of(build, "dropattn_bwd",
                                 f"dropattn_bwd_stream_(rows|cols)_kernelI{tname}Li{d}"),
    }


# the dropattn cases at head dim 32: the student's train lengths (bf16 on the
# resident backward), doc_len 512 and a ragged length past the resident
# limit (bf16 on the streaming backward), and f32 compute at L = 192 (the
# f32 tensor-core forward; the backward streaming: no resident f32 kernel at
# d = 32)
DROPATTN_D32_CASES = (((256, 12, 192, 32), torch.bfloat16), ((32, 12, 64, 32), torch.bfloat16),
                      ((256, 12, 512, 32), torch.bfloat16), ((32, 12, 264, 32), torch.bfloat16),
                      ((256, 12, 192, 32), torch.float32))


def phase_dropattn(gen, build: dict) -> tuple[list, dict, dict, dict]:
    """dropattn_fwd / dropattn_bwd at head dim 32 against their plain
    versions (DROPATTN_D32_CASES), p in {0, 0.1}: each on the route its
    (dtype, L) selects, one tensor-core backward launch a call (and one on
    the streaming route where that is the route), bitwise repeatable, bf16
    within the rounding bounds and f32 within 1e-5; the keep-masks read back
    bit for bit (L = 256 f32, L = 192 bf16 through the resident backward,
    L = 512 bf16 through the streaming one) and the streaming backward's
    packed keep bits equal to the plain ones at L = 512 and 264; times
    beside SDPA and the bounds, the streaming kernels' summed device time
    and ptxas's registers and spills, and at [256, 12, 192, 32] bf16 the
    streaming kernels beside the resident one. Returns the rows and the
    main entries of the resident forward and backward ([256, 12, 192, 32]
    bf16, p 0.1) and of the streaming backward ([256, 12, 512, 32] bf16)."""
    from sskd_tpu_torch.ops import attention as ta

    rows, main_fwd, main_bwd, main_stream, main_fwd_f32 = [], None, None, None, None
    check(masks_spelled_by_kernels(31), "dropattn kernels: applied keep-mask differs")
    log("[kernels] dropattn: the masks both kernels apply equal the plain mask (L = 256)")
    check(masks_spelled_bf16(37), "dropattn bf16 L=192: applied keep-mask differs")
    check(masks_spelled_stream_bf16(39), "dropattn bf16 L=512: applied keep-mask differs")
    log("[kernels] dropattn: bf16 at L = 192 and 512, the tensor-core forward and the resident "
        "and streaming backward apply the plain mask")
    for (B, h, L, d), dtype in DROPATTN_D32_CASES:
        BH = B * h
        f32 = dtype == torch.float32
        q, k, v, g = (torch.randn(B, h, L, d, device="cuda", generator=gen).to(dtype)
                      for _ in range(4))
        bias = attn_bias(B, L, gen)
        seed = 1000 + L
        check(masks_equal(seed, BH, L, 0.1), f"dropattn keep-mask [{BH}, {L}, {L}] differs")
        for p in (0.0, 0.1):
            tag = f"{str(dtype).split('.')[1]} L={L} p={p}"
            f_route = ta.dropattn_fwd_route(dtype, d, L)
            check(f_route == "tc", f"dropattn_fwd {tag}: route {f_route}")
            before = ta.dropattn_fwd.tc_launches
            out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
            check(ta.dropattn_fwd.tc_launches == before + (f_route == "tc"),
                  f"dropattn_fwd {tag}: the launch did not take the {f_route} route")
            f_again = ta.dropattn_fwd(q, k, v, bias, p, seed)
            check(torch.equal(out, f_again[0]) and torch.equal(lse, f_again[1]),
                  f"dropattn_fwd {tag}: two launches differ")
            del f_again
            want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
            route = ta.dropattn_bwd_route(dtype, d, L)
            check(route == ("tc" if L <= ta.DROPATTN_TC_MAX_L.get((dtype, d), 0)
                            else "tc_stream"), f"dropattn_bwd {tag}: route {route}")
            before = (ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.stream_launches)
            grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g)
            check((ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.stream_launches)
                  == (before[0] + 1, before[1] + (route == "tc_stream")),
                  f"dropattn_bwd {tag}: the launch did not take the {route} route")
            # no atomics, no order that varies: a second launch gives the same bits
            again = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"dropattn_bwd {tag}: two launches differ")
            del again
            want_grads = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, g)
            torch.cuda.synchronize()
            lse_err = (lse - want_lse).abs().max().item()
            check(lse_err <= 1e-4, f"dropattn_fwd lse {tag}: err {lse_err}")
            f_err = (out.float() - want.float()).abs().max().item()
            b_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, want_grads))
            entry = {"shape": [B, h, L, d], "dtype": str(dtype).split(".")[1], "p": p,
                     "lse_max_abs_err": lse_err, "fwd_max_abs_err": f_err,
                     "bwd_max_abs_err": b_err, "fwd_route": f_route, "bwd_route": route,
                     "bitwise_repeatable": True}
            if f32:  # summation order (and the TF32 terms' truncation)
                check(f_err <= 1e-5 and b_err <= 1e-5, f"dropattn {tag}: {f_err}, {b_err} > 1e-5")
            else:
                f_slack = ((out.float() - want.float()).abs() / ta.dropattn_fwd_error_bound(
                    q, k, v, bias, p, seed, out, want)).max().item()
                check(f_slack <= 1.0, f"dropattn_fwd {tag}: err {f_err} is {f_slack:.3f} "
                      "of its bound")
                bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, grads,
                                                     want_grads)
                b_slack = 0.0
                for name, a, b, bd in zip(("dq", "dk", "dv"), grads, want_grads, bounds):
                    slack = ((a.float() - b.float()).abs() / bd).max().item()
                    b_slack = max(b_slack, slack)
                    check(slack <= 1.0, f"dropattn_bwd {name} {tag}: {slack:.3f} of its bound")
                entry.update(fwd_err_over_bound=f_slack, bwd_err_over_bound=b_slack)
                del bounds
            if route == "tc_stream" and p > 0 and L in (512, 264):
                check(stream_bits_equal(q, k, v, bias, p, seed, lse, g),
                      f"dropattn_bwd {tag}: the packed keep bits differ from the plain mask")
                entry["keep_bits_equal"] = True
            if (B, L) == (256, 192) and p > 0 and not f32:
                # the streaming kernels at the resident kernel's length: the
                # same checks, and their times beside the resident kernel's
                s_grads = ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g)[:3]
                bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, s_grads,
                                                     want_grads)
                s_slack = max(((a.float() - b.float()).abs() / bd).max().item()
                              for a, b, bd in zip(s_grads, want_grads, bounds))
                check(s_slack <= 1.0, f"streaming dropattn_bwd {tag}: {s_slack:.3f} of its bound")
                entry["stream_err_over_bound"] = s_slack
                entry.update(stream_times(q, k, v, bias, p, seed, lse, g, build, "stream"))
                del s_grads, bounds
            del out, want, grads, want_grads
            if p > 0:
                entry.update(time_dropattn(q, k, v, g, bias, p, seed,
                                           fwd_kind="tf32" if f32 else "bf16",
                                           bwd_kind="tf32" if f32 else "bf16"))
                if f32:  # the f32 forward on the tensor cores: dropattn_fwd_tc_tf32_kernel<32>
                    entry.update(f32_forward_times(q, k, v, bias, p, seed, build))
                if route == "tc_stream":
                    entry.update(stream_times(q, k, v, bias, p, seed, lse, g, build))
                    entry["bwd_three_pass_ms"] = (3 * 10.0 * BH * L * L * d / PEAK_OPS["tf32"] * 1e3
                                                  if f32 else None)
            rows.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
            if (B, L) == (256, 192) and p > 0 and not f32:
                main_fwd = {"max_abs_err": f_err, "ms": entry["fwd_ms"],
                            "plain_ms": entry["fwd_plain_ms"], "bound_ms": entry["fwd_bound_ms"],
                            "bound_by": entry["fwd_bound_by"],
                            "library_ms": entry["fwd_library_ms"]}
                main_bwd = {"max_abs_err": b_err, "ms": entry["bwd_ms"],
                            "plain_ms": entry["bwd_plain_ms"], "bound_ms": entry["bwd_bound_ms"],
                            "bound_by": entry["bwd_bound_by"],
                            "library_ms": entry["bwd_library_ms"]}
            if (B, L) == (256, 192) and p > 0 and f32:
                main_fwd_f32 = {"max_abs_err": f_err, **{key: entry[f"fwd_{key}"] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            if (B, L) == (256, 512) and p > 0:
                main_stream = {"max_abs_err": b_err, "ms": entry["bwd_ms"],
                               "plain_ms": entry["bwd_plain_ms"],
                               "bound_ms": entry["bwd_bound_ms"], "bound_by": entry["bwd_bound_by"],
                               "library_ms": entry["bwd_library_ms"]}
            del lse
        del q, k, v, g
    return rows, main_fwd, main_bwd, main_stream, main_fwd_f32


def f32_forward_times(q, k, v, bias, p, seed, build: dict) -> dict:
    """The f32 tensor-core forward at head dim 16 or 32 beside its yardsticks:
    its device time alone (profiler; kernel_device_ms), SDPA with dropout's
    device time behind a held stream (every kernel of the call), the three
    TF32 passes at TF32's peak, the same products on the CUDA cores' FMA (the
    bound of the kernel this route replaced), the exp floor (one expf a
    score), the Philox calls, and ptxas's registers and spills of
    dropattn_fwd_tc_tf32_kernel<d>."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, d = q.shape
    ops = 4.0 * B * h * L * L * d
    mask = bias.to(q.dtype)[:, None, None, :]
    return {
        "fwd_kernel_device_ms": kernel_device_ms(
            lambda: ta.dropattn_fwd(q, k, v, bias, p, seed), "dropattn_fwd_tc_tf32_kernel"),
        "fwd_library_device_ms": stream_device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p)),
        "fwd_three_pass_ms": 3 * ops / PEAK_OPS["tf32"] * 1e3,
        "fwd_cuda_core_bound_ms": ops / PEAK_OPS["f32"] * 1e3,
        "fwd_exp_floor_ms_one_pass": B * h * L * L / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3,
        "philox_calls": B * h * L * L // 4,
        "fwd_ptxas": ptxas_of(build, "dropattn_fwd", f"tc_tf32_kernelILi{d}E"),
    }


def time_dropattn(q, k, v, g, bias, p, seed, fwd_kind=None, bwd_kind=None) -> dict:
    """ms per launch of both kernels, of their plain versions and of
    F.scaled_dot_product_attention with the same additive bias and dropout
    (forward, and its backward alone); the byte and operation bounds (the
    operations at the bf16 tensor-core rate, or the CUDA cores' f32 rate for
    f32 inputs; each kernel's at ``fwd_kind``'s / ``bwd_kind``'s where
    given)."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, d = q.shape
    BH = B * h
    _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    out = {
        "fwd_ms": time_ms(lambda: ta.dropattn_fwd(q, k, v, bias, p, seed), 10),
        "fwd_plain_ms": time_ms(lambda: ta.dropattn_fwd_plain(q, k, v, bias, p, seed), 2, 1),
        # the same forward without dropout: what drawing the mask costs it
        "fwd_no_dropout_ms": time_ms(lambda: ta.dropattn_fwd(q, k, v, bias, 0.0, seed), 10),
        "bwd_ms": time_ms(lambda: ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g), 10),
        "bwd_plain_ms": time_ms(lambda: ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, g),
                                2, 1),
        # the same backward without dropout: what drawing the mask costs
        "bwd_no_dropout_ms": time_ms(lambda: ta.dropattn_bwd(q, k, v, bias, 0.0, seed, lse, g),
                                     10),
    }
    mask = bias.to(q.dtype)[:, None, None, :]
    out["fwd_library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p), 10)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=p)
    out["bwd_library_ms"] = time_ms(
        lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True), 10)
    elt = BH * L * d * q.element_size()  # one [B, h, L, d] tensor
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    # The function's own bytes only: the lse the forward saves for the
    # backward is this port's choice (the TPU pair recomputes it), not part
    # of the function, so neither bound counts it.
    # forward: q, k, v, bias read, out written; 2 products of 2 L^2 d
    out["fwd_bound_ms"], out["fwd_bound_by"] = bound_ms(
        4 * elt + B * L * 4, 4.0 * BH * L * L * d, fwd_kind or kind)
    out["fwd_bytes_bound_ms"] = (4 * elt + B * L * 4) / HBM_BYTES_PER_S * 1e3
    # backward: q, k, v, g, bias read, dq, dk, dv written; 5 products
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound_ms(
        7 * elt + B * L * 4, 10.0 * BH * L * L * d, bwd_kind or kind)
    # floors above the bytes: the forward's two exps per score (one a pass)
    # on the special-function unit, 16 a clock an SM; the mask's Philox
    # work, measured as what dropout adds to the backward, which draws each
    # keep bit once, as the forward does
    out["fwd_exp_floor_ms"] = 2 * BH * L * L / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3
    out["philox_floor_ms"] = out["bwd_ms"] - out["bwd_no_dropout_ms"]
    return out


def masks_spelled_d64(seed: int, L: int) -> bool:
    """The read-back of masks_spelled_by_kernels at head dim 64 in f32: each
    probability 1/L, each kept pd 2/L at p = 0.5, v (and g) holding
    2^(j % 8) in channel j // 8; the forward is the f32 tensor-core kernel
    at every L (checked), the backward the resident one up to L = 128 and
    the streaming one past it (checked)."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, d = 2, 16, 64
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda")
    bias = torch.zeros(B, L, device="cuda")
    before = ta.dropattn_fwd.tc_launches
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    check(ta.dropattn_fwd.tc_launches == before + 1,
          f"dropattn_fwd f32 d=64 L={L}: not the tensor-core forward")
    before = (ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.stream_launches)
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    check((ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.stream_launches)
          == (before[0] + 1, before[1] + (L > 128)),
          f"dropattn_bwd f32 d=64 L={L}: not on the route its length selects")
    bit = torch.arange(8, device="cuda")

    def spell(x):
        n = (x[..., : L // 8] * (L / 2)).round().long()
        return ((n[..., None] >> bit) & 1).reshape(B, h, L, L).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    return bool((spell(out) == want).all()) and bool((spell(dv).transpose(-1, -2) == want).all())


def ptxas_of(build: dict, lib: str, pattern: str) -> dict:
    """The build summary (registers, shared memory, spills) of the kernels of
    library ``lib`` whose mangled name matches ``pattern``."""
    return {name: info for name, info in build.get(lib, {}).items() if re.search(pattern, name)}


# the dropattn cases at head dim 64: the teacher's train shape (the
# resident backward), L = 512 (the teacher at max_len 512, and the rerank
# length at B = 8) and ragged lengths past the resident limits (streaming)
DROPATTN_D64_CASES = (((32, 16, 64, 64), torch.float32), ((32, 16, 64, 64), torch.bfloat16),
                      ((8, 16, 512, 64), torch.float32), ((8, 16, 512, 64), torch.bfloat16),
                      ((32, 16, 512, 64), torch.float32), ((8, 16, 200, 64), torch.float32),
                      ((8, 16, 216, 64), torch.bfloat16))


def phase_attention64(gen, build: dict) -> tuple[list, dict]:
    """The attention kernels at the teacher's head dim 64 against their plain
    versions: dropattn_fwd / dropattn_bwd at DROPATTN_D64_CASES (the forward
    on the tensor cores, f32 as three TF32 products; the backward resident
    at [32, 16, 64, 64] and streaming past the resident lengths), p in {0,
    0.1}; flash_attn_fwd at the rerank shape [32, 16, 512, 64] on its
    tensor-core route, f32 and bf16. Every launch on the route (dtype, d, L)
    selects, one tensor-core launch a call (and one on the streaming route
    where that is the route), counted at d = 64, two launches bitwise equal,
    bf16 within the rounding bounds, f32 within 1e-5, the keep-mask read
    back bit for bit (through the tensor-core forward and the backward: f32
    at L = 64, 128, 256 and 512, bf16 at 192), the streaming backward's
    packed keep bits equal to the plain ones at L = 200; each timed by CUDA
    events and the profiler beside SDPA, the plain version and the bounds
    (the tensor cores' peak, three TF32 passes, and the CUDA cores' FMA
    rate), with ptxas's registers and spills, and at [32, 16, 64, 64] the
    streaming kernels beside the resident one. Returns the rows and the
    main entries (f32: the teacher computes in f32)."""
    from sskd_tpu_torch.ops import attention as ta

    rows, main = [], {}
    for L in (64, 128, 256, 512):
        check(masks_spelled_d64(53 + L, L), f"dropattn d=64 L={L}: applied keep-mask differs")
    check(masks_spelled_bf16(57, 64), "dropattn bf16 d=64 L=192: applied keep-mask differs")
    log("[kernels] dropattn d=64: both kernels apply the plain mask (f32, L = 64, 128, 256 and "
        "512; bf16, L = 192)")
    for (B, h, L, d), dtype in DROPATTN_D64_CASES:
        q, k, v, g = (torch.randn(B, h, L, d, device="cuda", generator=gen).to(dtype)
                      for _ in range(4))
        bias = attn_bias(B, L, gen)
        seed = 640 + L
        f32 = dtype == torch.float32
        for p in (0.0, 0.1):
            tag = f"{str(dtype).split('.')[1]} [{B}, {h}, {L}, {d}] p={p}"
            f_route, b_route = ta.dropattn_fwd_route(dtype, d, L), ta.dropattn_bwd_route(dtype, d, L)
            want_b = "tc" if L <= ta.DROPATTN_TC_MAX_L[(dtype, d)] else "tc_stream"
            check(f_route == "tc" and b_route == want_b,
                  f"dropattn d=64 {tag}: routes {f_route}, {b_route}")
            before = (ta.dropattn_fwd.tc_launches, ta.dropattn_fwd.head_dim_launches.get(64, 0),
                      ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.head_dim_launches.get(64, 0),
                      ta.dropattn_bwd.stream_launches)
            out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
            grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g)
            after = (ta.dropattn_fwd.tc_launches, ta.dropattn_fwd.head_dim_launches.get(64, 0),
                     ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.head_dim_launches.get(64, 0),
                     ta.dropattn_bwd.stream_launches)
            check(after == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1,
                            before[4] + (b_route == "tc_stream")),
                  f"dropattn d=64 {tag}: launches {before} -> {after}")
            again = ta.dropattn_fwd(q, k, v, bias, p, seed)
            g_again = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g)
            check(torch.equal(out, again[0]) and torch.equal(lse, again[1])
                  and all(torch.equal(a, b) for a, b in zip(grads, g_again)),
                  f"dropattn d=64 {tag}: two launches differ")
            del again, g_again
            want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
            want_grads = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, g)
            torch.cuda.synchronize()
            lse_err = (lse - want_lse).abs().max().item()
            check(lse_err <= 1e-4, f"dropattn_fwd d=64 lse {tag}: err {lse_err}")
            f_err = (out.float() - want.float()).abs().max().item()
            b_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, want_grads))
            entry = {"shape": [B, h, L, d], "dtype": str(dtype).split(".")[1], "p": p,
                     "lse_max_abs_err": lse_err, "fwd_max_abs_err": f_err,
                     "bwd_max_abs_err": b_err, "fwd_route": f_route, "bwd_route": b_route,
                     "bitwise_repeatable": True}
            if f32:  # summation order (and the TF32 terms' truncation)
                check(f_err <= 1e-5 and b_err <= 1e-5,
                      f"dropattn d=64 f32 {tag}: {f_err}, {b_err} > 1e-5")
            else:
                diff = (out.float() - want.float()).abs()
                f_slack = (diff / ta.dropattn_fwd_error_bound(q, k, v, bias, p, seed, out,
                                                             want)).max().item()
                bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, grads,
                                                     want_grads)
                b_slack = max(((a.float() - b.float()).abs() / bd).max().item()
                              for a, b, bd in zip(grads, want_grads, bounds))
                check(f_slack <= 1.0 and b_slack <= 1.0,
                      f"dropattn d=64 {tag}: {f_slack:.3f}, {b_slack:.3f} of the bounds")
                entry.update(fwd_err_over_bound=f_slack, bwd_err_over_bound=b_slack)
                del bounds
            if b_route == "tc_stream" and p > 0 and L == 200:
                check(stream_bits_equal(q, k, v, bias, p, seed, lse, g),
                      f"dropattn_bwd d=64 {tag}: the packed keep bits differ from the plain mask")
                entry["keep_bits_equal"] = True
            if b_route == "tc" and p > 0:
                # the streaming kernels at the resident kernel's length
                s_grads = ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g)[:3]
                if f32:
                    s_err = max((a - b).abs().max().item() for a, b in zip(s_grads, want_grads))
                    check(s_err <= 1e-5, f"streaming dropattn_bwd d=64 {tag}: {s_err} > 1e-5")
                    entry["stream_max_abs_err"] = s_err
                else:
                    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, s_grads,
                                                         want_grads)
                    s_slack = max(((a.float() - b.float()).abs() / bd).max().item()
                                  for a, b, bd in zip(s_grads, want_grads, bounds))
                    check(s_slack <= 1.0, f"streaming dropattn_bwd d=64 {tag}: {s_slack:.3f}")
                    entry["stream_err_over_bound"] = s_slack
                    del bounds
                entry.update(stream_times(q, k, v, bias, p, seed, lse, g, build, "stream"))
                del s_grads
            del out, lse, grads, want, want_lse, want_grads
            if p > 0:
                tc_kind = "tf32" if f32 else "bf16"
                entry.update(time_dropattn(q, k, v, g, bias, p, seed, fwd_kind=tc_kind,
                                           bwd_kind=tc_kind))
                _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
                # the tensor-core forward's kernel by name: dropattn_fwd_tc_tf32_kernel<64>
                # in f32, dropattn_fwd_tc_kernel<64> in bf16; the backward's one kernel,
                # or its three streaming kernels summed
                entry["fwd_kernel_device_ms"] = kernel_device_ms(
                    lambda: ta.dropattn_fwd(q, k, v, bias, p, seed),
                    "dropattn_fwd_tc_tf32_kernel" if f32 else "dropattn_fwd_tc_kernel")
                entry["bwd_kernel_device_ms"] = kernel_device_ms(
                    lambda: ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g),
                    "dropattn_bwd_tc" if b_route == "tc" else "dropattn_bwd_stream")
                del lse
                fwd_ops, ops = 4.0 * B * h * L * L * d, 10.0 * B * h * L * L * d
                entry["fwd_cuda_core_bound_ms"] = fwd_ops / PEAK_OPS["f32"] * 1e3
                entry["bwd_cuda_core_bound_ms"] = ops / PEAK_OPS["f32"] * 1e3
                # the keep-mask: one Philox4x32-10 call for four keys of a row
                entry["philox_calls"] = B * h * L * L // 4
                if f32:
                    entry["fwd_three_pass_ms"] = 3 * fwd_ops / PEAK_OPS["tf32"] * 1e3
                    entry["bwd_three_pass_ms"] = 3 * ops / PEAK_OPS["tf32"] * 1e3
                entry["fwd_ptxas"] = ptxas_of(build, "dropattn_fwd", "tc_tf32_kernelILi64"
                                              if f32 else "tc_kernelILi64")
                entry["bwd_ptxas"] = ptxas_of(
                    build, "dropattn_bwd",
                    ("tc_tf32_kernelILi64" if f32 else "tc_kernelILi64") if b_route == "tc"
                    else "dropattn_bwd_stream_(rows|cols)_kernelI" + ("f" if f32 else
                                                                      "13__nv_bfloat16") + "Li64")
                if (B, L) == (32, 64) and f32:
                    for name, pre in (("dropattn_fwd.d64", "fwd"), ("dropattn_bwd.d64", "bwd")):
                        main[name] = {
                            "max_abs_err": f_err if pre == "fwd" else b_err,
                            **{key: entry[f"{pre}_{key}"] for key in
                               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                if (B, L) == (32, 512) and f32:
                    main["dropattn_bwd.stream.d64"] = {
                        "max_abs_err": b_err,
                        **{key: entry[f"bwd_{key}"] for key in
                           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            rows.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
        del q, k, v, g

    B, h, L, d = 32, 16, 512, 64
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, h, L, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        lens = torch.randint(L // 8, L + 1, (B,), device="cuda", generator=gen)
        lens[0] = L
        mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        route = ta.flash_route(dtype, d)
        check(route == "tc", f"flash d=64: route {route}")
        before = (ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches.get(64, 0))
        got = ta.flash_attention(q, k, v, mask)
        check((ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches.get(64, 0))
              == (before[0] + 1, before[1] + 1), "flash d=64: not one tensor-core launch at d = 64")
        check(torch.equal(got, ta.flash_attention(q, k, v, mask)), "flash d=64: launches differ")
        want = ta.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        entry = {"kernel": "flash_attn_fwd", "dtype": str(dtype).split(".")[1],
                 "shape": [B, h, L, d], "route": route, "max_abs_err": err,
                 "max_rel_err": rel_err(got, want)}
        if dtype == torch.float32:
            check(err <= 1e-5, f"flash_attn_fwd d=64 f32: max abs err {err} > 1e-5")
        else:
            slack = (diff / ta.flash_error_bound(q, k, v, mask, got, want)).max().item()
            check(slack <= 1.0, f"flash_attn_fwd d=64 bf16: {slack:.3f} of its bound")
            entry["err_over_bound"] = slack
        del got, want, diff
        keep = mask[:, None, None, :].bool()
        ops = 4.0 * B * h * L * L * d
        b_ms, b_by = bound_ms(4 * B * h * L * d * q.element_size() + B * L * 4, ops,
                              "tf32" if dtype == torch.float32 else "bf16")
        entry.update({
            "ms": time_ms(lambda: ta.flash_attention(q, k, v, mask), 10),
            "kernel_device_ms": kernel_device_ms(lambda: ta.flash_attention(q, k, v, mask),
                                                 "flash_fwd_tc"),
            "plain_ms": time_ms(lambda: ta.flash_attention_plain(q, k, v, mask), 3, 1),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 10),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_bound_ms": (4 * B * h * L * d * q.element_size() + B * L * 4)
            / HBM_BYTES_PER_S * 1e3,
            "cuda_core_bound_ms": ops / PEAK_OPS["f32"] * 1e3,
            "exp_floor_ms": B * h * L * L / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3,
            "ptxas": ptxas_of(build, "flash_attn", "tc_tf32_kernelILi64"
                              if dtype == torch.float32 else "tc2_kernelILi64"),
        })
        if dtype == torch.float32:
            entry["three_pass_ms"] = 3 * ops / PEAK_OPS["tf32"] * 1e3
        rows.append(entry)
        log(f"[kernels] {json.dumps(entry)}")
        if dtype == torch.float32:
            main["flash_attn_fwd.d64"] = {key: entry[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        del q, k, v
    return rows, main


# head dim 16 (BertConfig.tiny: hidden 64, 4 heads), the shapes the pipeline
# phase's --tiny runs launch: the bf16 student's doc tower (32 queries x 8 docs
# at doc_len 192) and query tower (query_len 64), and the f32 teacher's train
# step (batch 32, max_len 64)
DROPATTN_D16_CASES = (((256, 4, 192, 16), torch.bfloat16), ((32, 4, 64, 16), torch.bfloat16),
                      ((32, 4, 64, 16), torch.float32))


def phase_attention16(gen, build: dict, probe) -> tuple[list, dict]:
    """dropattn_fwd / dropattn_bwd at head dim 16 against their plain
    versions (DROPATTN_D16_CASES), p in {0, 0.1}: bf16 on the tensor cores
    (dropattn_fwd_tc_kernel<16>, the resident dropattn_bwd_tc_kernel<16>),
    f32 on dropattn_fwd_tc_tf32_kernel<16> (f32_forward_times beside it)
    and the streaming backward; the
    kernels' keep-mask equal to the plain one bit for bit, the backward
    bitwise equal over two launches, bf16 within dropattn_*_error_bound and
    f32 within 1e-5 (1 + |want|); times beside SDPA with dropout and its
    backward, and the bounds; then flash in bf16 (flash_d16_case, the
    CUDA-core kernel it replaced from ``probe``). Returns the rows and the
    main entries (the bf16 doc tower's shape, the f32 teacher's, flash at
    [256, 4, 512, 16])."""
    from sskd_tpu_torch.ops import attention as ta

    rows, main = [], {}
    for (B, h, L, d), dtype in DROPATTN_D16_CASES:
        f32 = dtype == torch.float32
        q, k, v, g = (torch.randn(B, h, L, d, device="cuda", generator=gen).to(dtype)
                      for _ in range(4))
        bias = attn_bias(B, L, gen)
        seed = 1600 + L + B
        check(masks_equal(seed, B * h, L, 0.1), f"dropattn d=16 keep-mask [{B * h}, {L}] differs")
        f_route, b_route = ta.dropattn_fwd_route(dtype, d, L), ta.dropattn_bwd_route(dtype, d, L)
        check((f_route, b_route) == (("tc", "tc_stream") if f32 else ("tc", "tc")),
              f"dropattn d=16 {dtype} L={L}: routes {f_route}, {b_route}")
        for p in (0.0, 0.1):
            tag = f"d=16 {str(dtype).split('.')[1]} [{B}, {h}, {L}] p={p}"
            before = (ta.dropattn_fwd.head_dim_launches.get(16, 0), ta.dropattn_fwd.tc_launches,
                      ta.dropattn_bwd.head_dim_launches.get(16, 0), ta.dropattn_bwd.tc_launches,
                      ta.dropattn_bwd.stream_launches, ta.dropattn_bwd.three_pass_launches)
            out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
            grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g)
            check((ta.dropattn_fwd.head_dim_launches[16], ta.dropattn_fwd.tc_launches,
                   ta.dropattn_bwd.head_dim_launches[16], ta.dropattn_bwd.tc_launches,
                   ta.dropattn_bwd.stream_launches, ta.dropattn_bwd.three_pass_launches)
                  == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1,
                      before[4] + f32, before[5] + (not f32)),
                  f"dropattn {tag}: launches not counted on their routes (bf16: the three-pass "
                  "kernel)")
            again = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"dropattn_bwd {tag}: two launches differ")
            del again
            want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
            want_grads = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, g)
            torch.cuda.synchronize()
            lse_err = (lse - want_lse).abs().max().item()
            check(lse_err <= 1e-4, f"dropattn_fwd lse {tag}: err {lse_err}")
            f_err = (out.float() - want.float()).abs().max().item()
            b_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, want_grads))
            entry = {"shape": [B, h, L, d], "dtype": str(dtype).split(".")[1], "p": p,
                     "lse_max_abs_err": lse_err, "fwd_max_abs_err": f_err,
                     "bwd_max_abs_err": b_err, "fwd_route": f_route, "bwd_route": b_route,
                     "bitwise_repeatable": True}
            if f32:
                for name, a, b in (("out", out, want),) + tuple(zip(("dq", "dk", "dv"), grads,
                                                                      want_grads)):
                    ratio = ((a - b).abs() / (1 + b.abs())).max().item()
                    check(ratio <= 1e-5, f"dropattn {name} {tag}: {ratio} > 1e-5 (1 + |want|)")
            else:
                f_slack = ((out.float() - want.float()).abs() / ta.dropattn_fwd_error_bound(
                    q, k, v, bias, p, seed, out, want)).max().item()
                check(f_slack <= 1.0, f"dropattn_fwd {tag}: {f_slack:.3f} of its bound")
                bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, grads,
                                                     want_grads)
                b_slack = max(((a.float() - b.float()).abs() / bd).max().item()
                              for a, b, bd in zip(grads, want_grads, bounds))
                check(b_slack <= 1.0, f"dropattn_bwd {tag}: {b_slack:.3f} of its bound")
                entry.update(fwd_err_over_bound=f_slack, bwd_err_over_bound=b_slack)
                entry.update(d16_backward_candidates(q, k, v, bias, p, seed, lse, g, grads,
                                                     want_grads, build, tag))
                del bounds
            del out, want, grads, want_grads, lse
            if p > 0:
                entry.update(time_dropattn(q, k, v, g, bias, p, seed,
                                           fwd_kind="tf32" if f32 else "bf16",
                                           bwd_kind="tf32" if f32 else "bf16"))
                if f32:
                    entry.update(f32_forward_times(q, k, v, bias, p, seed, build))
                name = "d16.f32" if f32 else "d16"
                if (f32 or L == 192) and f"dropattn_fwd.{name}" not in main:
                    for kern, pre, err in (("dropattn_fwd", "fwd", f_err),
                                           ("dropattn_bwd", "bwd", b_err)):
                        main[f"{kern}.{name}"] = {
                            "max_abs_err": err, "ms": entry[f"{pre}_ms"],
                            "plain_ms": entry[f"{pre}_plain_ms"],
                            "bound_ms": entry[f"{pre}_bound_ms"],
                            "bound_by": entry[f"{pre}_bound_by"],
                            "library_ms": entry[f"{pre}_library_ms"]}
                    if not f32:
                        main["dropattn_bwd.d16"].update({
                            f"{n}_device_ms": entry[f"bwd_{n}_device_ms"]
                            for n in ("buffer_kernel", "three_pass", "stream")})
            rows.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
        del q, k, v, g
    flash = flash_d16_case(gen.initial_seed() + 2, build, probe)
    rows.append(flash)
    main["flash_attn_fwd.d16"] = {key: flash[key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "kernel_device_ms", "cuda_core_kernel_device_ms")}
    return rows, main


def probe_module(name: str):
    """tools/<name>.py loaded as a module (tools/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# flash in bf16 at head dim 16: the tiny models' encode shape with a ragged
# mask and a row with no live key, a ragged last tile (L = 200) and B = 1
FLASH_D16_CASES = ((256, 512), (64, 200), (1, 512))


def flash_d16_case(seed: int, build: dict, probe) -> dict:
    """flash_attn_fwd in bf16 at head dim 16 on its tensor-core route
    (flash_fwd_tc2_kernel<16, 2, 4>; the --tiny models' encode at L = 512),
    FLASH_D16_CASES with ragged key masks (from B = 3 the second row with
    no live key): one tensor-core launch a call counted at d = 16, within
    flash_error_bound of the plain version, the same bits over two launches;
    at [256, 4, 512, 16] its time beside the plain version's, SDPA's, the
    CUDA-core kernel's that the route took before (flash_fwd_kernel, built
    from tools/flash_d16_variants.cuh by ``probe``: tools/probe_flash16.py's
    start_build, started with the build phase), the byte bound and the exp
    floor, and ptxas's registers and spills of both. Its inputs come from a
    generator of their own. Returns the [256, 4, 512, 16] entry with the
    other cases under "cases"."""
    from sskd_tpu_torch.ops import attention as ta

    flash16 = probe_module("probe_flash16")
    old_fn, old_ptxas = flash16.load(probe)
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, cases = 16, []
    route = ta.flash_route(torch.bfloat16, d)
    check(route == "tc", f"flash bf16 d=16: route {route}")
    for B, L in FLASH_D16_CASES:
        q, k, v, mask = flash16.inputs(B, L, "ragged", g)
        h, tag = q.shape[1], f"flash bf16 d=16 [{B}, 4, {L}, 16]"
        before = (ta.flash_attention.launches, ta.flash_attention.tc_launches,
                  ta.flash_attention.head_dim_launches.get(d, 0))
        got = ta.flash_attention(q, k, v, mask)
        check((ta.flash_attention.launches, ta.flash_attention.tc_launches,
               ta.flash_attention.head_dim_launches[d])
              == (before[0] + 1, before[1] + 1, before[2] + 1),
              f"{tag}: not one tensor-core launch at d = 16")
        check(torch.equal(got, ta.flash_attention(q, k, v, mask)), f"{tag}: launches differ")
        want = ta.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        slack = (diff / ta.flash_error_bound(q, k, v, mask, got, want)).max().item()
        check(slack <= 1.0, f"{tag}: {slack:.3f} of its bound")
        case = {"shape": [B, h, L, d], "max_abs_err": diff.max().item(), "err_over_bound": slack,
                "no_live_key_rows": int((mask.sum(dim=1) == 0).sum().item()),
                "bitwise_repeatable": True}
        if (B, L) != FLASH_D16_CASES[0]:
            cases.append(case)
            log(f"[kernels] {tag}: {json.dumps(case)}")
            continue
        old_out = torch.empty_like(q)
        old_call = flash16.launcher(old_fn, flash16.VARIANTS["cuda_core"], q, k, v, mask, old_out)
        old_call()
        torch.cuda.synchronize()
        old_slack = ((old_out.float() - want.float()).abs()
                     / ta.flash_error_bound(q, k, v, mask, old_out, want)).max().item()
        check(old_slack <= 1.0, f"{tag}: the CUDA-core kernel at {old_slack:.3f} of its bound")
        call = lambda: ta.flash_attention(q, k, v, mask)  # noqa: E731
        keep = mask[:, None, None, :].bool()
        b_ms, b_by = bound_ms(4 * B * h * L * d * 2 + B * L * 4, 4.0 * B * h * L * L * d, "bf16")
        entry = {
            "kernel": "flash_attn_fwd", "dtype": "bf16", "route": route, **case,
            "ms": time_ms(call, 10),
            "kernel_device_ms": kernel_device_ms(call, "flash_fwd_tc2_kernel<16", 8),
            "cuda_core_kernel_device_ms": kernel_device_ms(old_call, "flash_fwd_kernel", 8),
            "cuda_core_err_over_bound": old_slack,
            "plain_ms": time_ms(lambda: ta.flash_attention_plain(q, k, v, mask), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_bound_ms": (4 * B * h * L * d * 2 + B * L * 4) / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 10),
            "library_device_ms": stream_device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 8),
            "exp_floor_ms": B * h * L * L / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3,
            "ptxas": {**ptxas_of(build, "flash_attn", "tc2_kernelILi16"),
                      **{n: i for n, i in old_ptxas.items() if "flash_fwd_kernel" in n}},
        }
        log(f"[kernels] {tag}: {json.dumps(entry)}")
        del old_out
    entry["cases"] = cases
    return entry


def d16_backward_candidates(q, k, v, bias, p, seed, lse, g, route_grads, want, build,
                            tag) -> dict:
    """The bf16 backward at head dim 16 beside the kernel its route took
    before: dropattn_bwd_tc_kernel<16> (the [Lp, Lp] buffer; reached through
    the probe entry only) and the streaming route's three kernels, each
    within dropattn_bwd_error_bound of the plain pair; whether the buffer
    kernel gives the route's (three-pass) bits; the device time of each from
    a held stream, and ptxas's registers and spills of both resident
    kernels."""
    from sskd_tpu_torch.ops import attention as ta

    out = {}
    calls = {"three_pass": lambda: ta.dropattn_bwd(q, k, v, bias, p, seed, lse, g),
             "buffer_kernel": lambda: ta.dropattn_bwd_tc_kernel(0, q, k, v, bias, p, seed, lse,
                                                                g),
             "stream": lambda: ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g)[:3]}
    for name in ("buffer_kernel", "stream"):
        got = calls[name]()
        torch.cuda.synchronize()
        bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, got, want)
        slack = max(((a.float() - b.float()).abs() / bd).max().item()
                    for a, b, bd in zip(got, want, bounds))
        check(slack <= 1.0, f"dropattn_bwd {name} {tag}: {slack:.3f} of its bound")
        out[f"bwd_{name}_err_over_bound"] = slack
        if name == "buffer_kernel":
            out["bwd_three_pass_bitwise_equal_buffer_kernel"] = all(
                torch.equal(a, b) for a, b in zip(got, route_grads))
        del got, bounds
    for name, call in calls.items():
        out[f"bwd_{name}_device_ms"] = stream_device_ms(call, 20)
    out["bwd_ptxas"] = ptxas_of(build, "dropattn_bwd", r"tc_(3pass_)?kernelILi16E")
    return out


def phase_cells(gen, dim: int = 384) -> tuple[list, dict, dict]:
    """cell_gather and cell_gather_b1 against their plain versions over 977
    cells x 1,024 rows (seeded unit rows; each query probes 64 distinct random
    cells), in int8, f32 and bf16 (the query rounded to bf16). Timed over a
    rotation of probes, so that a launch does not find its cells in L2 from
    the launch before. Beside each: the bound from the distinct cells of the
    timed probes, the plain version, and two yardsticks the port never calls:
    bin_gather over the cells spelled out as 128-row bins, and index_select +
    bmm over the gathered rows; for one query also the kernel alone on the
    card, without the wrapper's query-scale multiply. Returns (rows, the
    main-path entries, the bf16 entries), each by kernel name."""
    from sskd_tpu_torch.ops import _build
    from sskd_tpu_torch.ops import topk_cluster as tc
    from sskd_tpu_torch.ops import topk_kernels as tk
    from sskd_tpu_torch.ops.quant import quantize_rows

    x = unit_rows(N_CELLS * CELL_ROWS, dim, gen)
    rows, main, bf16 = [], {}, {}
    check(tc.cell_gather_route(torch.int8, dim) == "tc", "int8 cell_gather: not the tensor cores")
    b1_fn = tk._fn("cell_gather", "sskd_cell_gather_b1")

    def b1_kernel(q_in, q_scale, corpus, scales, probe, rpc):
        """cell_gather_b1_kernel's launch alone (the C entry point)."""
        out = torch.empty((1, probe.shape[1], rpc), dtype=torch.float32, device="cuda")
        _build.check(b1_fn(tc._MODES[corpus.dtype], tk._ptr(q_in), tk._ptr(corpus),
                           tk._ptr(scales), tk._ptr(probe), tk._ptr(out), probe.shape[1], rpc,
                           corpus.shape[1] * corpus.element_size(), tk._stream(corpus.device)),
                     "cell_gather_b1 (alone)")
        return out

    def probes(B, nprobe, n_cells):
        return torch.stack([torch.randperm(n_cells, device="cuda", generator=gen)[:nprobe]
                            for _ in range(B)]).to(torch.int32).contiguous()

    for dtype in ("int8", "f32", "bf16"):
        corpus, scales = {"int8": lambda: quantize_rows(x), "f32": lambda: (x, None),
                          "bf16": lambda: (x.to(torch.bfloat16), None)}[dtype]()
        row_bytes = corpus.shape[1] * corpus.element_size()
        tol = 0.0 if dtype == "int8" else 1e-5
        # a ragged case first: nprobe 11 over cells of 768 rows, both kernels
        for B in (1, 3):
            q_in, q_scale = tc.cell_queries(unit_rows(B, dim, gen), corpus)
            probe = probes(B, 11, corpus.shape[0] // 768)
            fn, plain = ((tc.cell_gather_b1, tc.cell_gather_b1_plain) if B == 1
                         else (tc.cell_gather, tc.cell_gather_plain))
            got = fn(q_in, q_scale, corpus, scales, probe, 768)
            want = plain(q_in, q_scale, corpus, scales, probe, 768)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(got.shape == (B, 11, 768) and err <= tol,
                  f"{fn.__name__} {dtype} ragged B={B}: max abs err {err} > {tol}")
        for B in (1, 16) if dtype == "f32" else (1, 16, 64):
            name = "cell_gather_b1" if B == 1 else "cell_gather"
            fn, plain = ((tc.cell_gather_b1, tc.cell_gather_b1_plain) if B == 1
                         else (tc.cell_gather, tc.cell_gather_plain))
            n_sets = 8 if B == 1 else 2
            sets = []
            for _ in range(n_sets):
                q_in, q_scale = tc.cell_queries(unit_rows(B, dim, gen), corpus)
                sets.append((q_in, q_scale, corpus, scales, probes(B, NPROBE, N_CELLS),
                             CELL_ROWS))
            err = 0.0
            for a in sets[:2]:
                got, want = fn(*a), plain(*a)
                torch.cuda.synchronize()
                err = max(err, (got - want).abs().max().item())
                max_rel = rel_err(got, want)
                del got, want
            check(err <= tol, f"{name} {dtype} B={B}: max abs err {err} > {tol}")
            # timed as the engine calls it: without the probe's range check,
            # which waits for the device
            route = (tc.cell_gather_route(corpus.dtype, row_bytes) if B > 1
                     else "bf16" if dtype == "bf16" else "cuda_core")
            before = (fn.launches, getattr(fn, "tc_launches", 0), fn.bf16_launches)
            fn(*sets[0])
            after = (fn.launches, getattr(fn, "tc_launches", 0), fn.bf16_launches)
            check(after == (before[0] + 1, before[1] + (route == "tc"),
                            before[2] + (route == "bf16")),
                  f"{name} {dtype} B={B}: the launch did not take the {route} route")
            fast = rotating(lambda *a: fn(*a, check_probe=False), sets)
            ms = time_ms(fast, 40, 4)
            device_ms = kernel_device_ms(
                fast, name + ("_tc_kernel" if route == "tc" else "_kernel"))
            plain_ms = time_ms(rotating(plain, sets), 2, 1)
            # bytes: each distinct probed cell once with its scales, the
            # queries, the probe, and every score once (mean over the sets)
            distinct = float(np.mean([torch.unique(a[4]).numel() for a in sets]))
            n_bytes = (distinct * CELL_ROWS * (row_bytes + 4 * (scales is not None))
                       + B * row_bytes + B * NPROBE * 4 + B * NPROBE * CELL_ROWS * 4)
            b_ms, b_by = bound_ms(n_bytes, 2.0 * B * NPROBE * CELL_ROWS * dim,
                                  "int8" if dtype == "int8" else "f32")

            def as_bins(q_in, q_scale, corpus, scales, probe, rpc):
                per = rpc // 128
                lane = torch.arange(per, device="cuda", dtype=torch.int32)
                bins = (probe[:, :, None] * per + lane).reshape(probe.shape[0], -1).contiguous()
                if corpus.dtype == torch.bfloat16:  # the rounded query, widened: the same scores
                    q_in = q_in.float()
                return tk.bin_gather(q_in, q_scale, corpus, scales, bins)

            def gather_bmm(q_in, q_scale, corpus, scales, probe, rpc):
                cells = corpus.view(-1, rpc * corpus.shape[1])
                picked = cells.index_select(0, probe.reshape(-1).long())
                picked = picked.view(probe.shape[0], -1, corpus.shape[1]).float()
                s = torch.bmm(picked, q_in.float()[:, :, None])[:, :, 0]
                if scales is not None:
                    s = s * scales.view(-1, rpc)[probe.long()].view(probe.shape[0], -1)
                return s * q_scale[:, None] if q_scale is not None else s

            bins_ms = time_ms(rotating(as_bins, sets), 20, 2)
            bmm_ms = time_ms(rotating(gather_bmm, sets), 3, 1) if B <= 16 else None
            # one query: the kernel alone on the card, CUDA events behind the held
            # stream (the whole call adds the query-scale multiply of int8)
            alone_ms = (stream_device_ms(rotating(b1_kernel, sets), 32) if B == 1 else None)
            entry = {
                "kernel": name, "dtype": dtype, "B": B, "nprobe": NPROBE, "route": route,
                "cells": [N_CELLS, CELL_ROWS, dim], "distinct_cells": distinct,
                "max_abs_err": err, "max_rel_err": max_rel, "ms": ms,
                "kernel_device_ms": device_ms, "kernel_alone_device_ms": alone_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "bin_gather_ms": bins_ms, "index_select_bmm_ms": bmm_ms,
                "gb_per_s": n_bytes / ms / 1e6,
            }
            rows.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
            if B in (1, 16) and dtype in ("int8", "bf16"):
                (main if dtype == "int8" else bf16)[name] = entry
            del sets
        del corpus, scales
    return rows, main, bf16


# ---------------------------------------------------------------------------
# Phase 3: the main path, served
# ---------------------------------------------------------------------------


def make_passages(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, 520)) for _ in range(n)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(port: int, method: str, path: str, body: dict | None = None,
            headers: dict | None = None, timeout: float = 300.0) -> tuple[int, dict | str, float]:
    """(status, JSON body or text, ms) of one request to 127.0.0.1:``port``."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
        try:
            return resp.status, json.loads(raw), ms
        except ValueError:
            return resp.status, raw.decode(), ms
    finally:
        conn.close()


def post(port: int, path: str, body: dict, timeout: float = 300.0) -> tuple[int, dict, float]:
    return request(port, "POST", path, body, timeout=timeout)


def get(port: int, path: str) -> int:
    return request(port, "GET", path, timeout=30)[0]


def loadgen(port: int, n_requests: int, clients: int, seed: int, rerank: bool = False) -> dict:
    """Closed-loop load: ``clients`` threads, each sending its share of
    ``n_requests`` /search requests one after another (with ``rerank``
    true when asked; a response that says ``reranked: false`` then counts
    as failed). Runs in its own process (``--loadgen``), so the clients do
    not share the server's interpreter lock."""
    rng = np.random.default_rng(seed)
    queries = [" ".join(rng.choice(WORDS, 6)) for _ in range(n_requests)]
    per_client = [queries[i::clients] for i in range(clients)]

    def client(qs):
        out = []
        for q in qs:
            try:
                status, body, ms = post(port, "/search", {"query": q, "k": 10, "rerank": rerank})
                if rerank and status == 200 and body.get("reranked") is not True:
                    status = -1
            except OSError:
                status, ms = 0, float("inf")
            out.append((status, ms))
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        done = [r for part in pool.map(client, per_client) for r in part]
    wall = time.perf_counter() - t0
    lat = sorted(ms for _, ms in done)
    failed = sum(status != 200 for status, _ in done)
    return {
        "clients": clients, "requests": len(done), "failed": failed,
        "not_reranked": sum(status == -1 for status, _ in done),
        "queries_per_s": len(done) / wall, "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)), "max_ms": lat[-1],
    }


def run_load(port: int, n_requests: int, clients: int, seed: int, rerank: bool = False) -> dict:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         "--loadgen", f"{port},{n_requests},{clients},{int(rerank)}"],
        capture_output=True, text=True, timeout=900, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def live_server(app, tag: str):
    """Serve ``app`` on 127.0.0.1 from a thread of this process; yields
    ``(port, seconds until /ready)`` and shuts the server down on exit. A
    failed startup or a server that does not stop fails the run."""
    from sskd_tpu_torch.serve.http import Server

    port = free_port()
    server = Server(app, host="127.0.0.1", port=port, handle_signals=False)
    loop = asyncio.new_event_loop()
    served: dict = {}

    def on_serve_done(task):
        if not task.cancelled() and task.exception() is not None:
            served["error"] = task.exception()  # e.g. a failed startup
            loop.stop()

    def run_server():
        # the loop runs until stopped, so that Server.shutdown (which ends
        # serve()) can finish its drain on it
        loop.create_task(server.serve()).add_done_callback(on_serve_done)
        loop.run_forever()

    thread = threading.Thread(target=run_server, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        while True:
            check(thread.is_alive(), f"server died at startup: {served.get('error')!r}")
            check(time.perf_counter() - t0 < 600, "server not ready after 600 s")
            try:
                if get(port, "/ready") == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        startup_s = time.perf_counter() - t0
        log(f"[{tag}] app ready on 127.0.0.1:{port} after {startup_s:.1f} s "
            "(checkpoint + index load + warmup)")
        yield port, startup_s
    finally:
        if thread.is_alive():
            asyncio.run_coroutine_threadsafe(server.shutdown(drain_timeout=5.0), loop).result(60)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(60)
    check(not thread.is_alive(), "server thread did not stop")
    check("error" not in served, f"server failed: {served.get('error')!r}")
    loop.close()


def breakdown(fused, seed: int, reps: int = 30) -> dict:
    """Where one fused search's time goes, in-process: host clock around
    tokenize, encode, top-k and the copy back (each ended by a synchronize),
    and the device's busy share from torch.profiler over a window of calls."""
    from sskd_tpu_torch.ops.topk import cosine_topk

    st, b = fused.student, fused.builder
    rng = np.random.default_rng(seed)
    out = {}
    for n in (1, 64):
        texts = [st.query_prefix + " ".join(rng.choice(WORDS, 6)) for _ in range(n)]
        parts = {"tokenize_ms": 0.0, "encode_ms": 0.0, "topk_ms": 0.0, "copy_ms": 0.0}
        for _ in range(reps):
            t0 = time.perf_counter()
            batch = st.tokenize_batch(texts + [st.query_prefix] * (max(16, n) - n))
            t1 = time.perf_counter()
            q = st.forward_batch(batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            vals, idx = cosine_topk(q, b.device_vectors, 10, row_scales=b.device_scales,
                                    valid_n=b.ntotal)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            vals.cpu(), idx.cpu()
            t4 = time.perf_counter()
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[key] += dt * 1e3 / reps
        queries = [t[len(st.query_prefix):] for t in texts]
        t0 = time.perf_counter()
        for _ in range(reps):
            fused.search_texts(queries, 10)
        parts["search_texts_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        # device busy share: kernel time over wall time, in a profiled window
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                fused.search_texts(queries, 10)
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(t for _, t in device_times(prof))
        parts["device_busy_share"] = busy_us / wall_us if busy_us > 0 else None
        out[f"B={n}"] = parts
        log(f"[serve] breakdown B={n}: {json.dumps(parts)}")
    return out


def phase_serve(args, gen) -> dict:
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.ops.topk import cosine_topk_core
    from sskd_tpu_torch.serve.app import create_app
    from sskd_tpu_torch.serve.fused import K_BUCKETS

    work = ROOT / "build" / "chip_smoke"
    passages = make_passages(N_DOCS, args.seed)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

    student = StudentModel(
        "intfloat/e5-small-v2", device="cuda", compute_dtype=torch.bfloat16, seed=args.seed
    )
    check(student.config.hidden_size == 384 and student.config.num_layers == 12, "not e5 width")
    lengths = [len(student.tokenizer.tokenize(student.passage_prefix + p)) for p in passages[:64]]
    check(min(lengths) >= 510, f"passages of {min(lengths)} tokens, want >= 510")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    doc_emb = student.encode_documents(passages, batch_size=256)
    encode_s = time.perf_counter() - t0
    check(doc_emb.shape == (N_DOCS, 384) and np.isfinite(doc_emb).all(), "bad doc embeddings")
    docs_per_s = N_DOCS / encode_s
    log(f"[serve] encoded {N_DOCS} passages at L=512 in {encode_s:.2f} s "
        f"({docs_per_s:.1f} docs/s)")

    fill = unit_rows(N_ROWS - N_DOCS, 384, gen).cpu().numpy()
    emb = np.concatenate([doc_emb, fill])
    del fill
    ids = [f"doc-{i}" for i in range(N_ROWS)]
    builder = IndexBuilder(384, index_type="exact", dtype="int8", device="cuda")
    builder.build_from_arrays(emb, ids, texts=passages)
    builder.save(work / "index")
    student.save(work / "student")

    settings = Settings.from_dict({
        "index": {"search_method": "exact"},
        "service": {"micro_batch_window_ms": 5.0, "micro_batch_max_size": 64},
    })
    app = create_app(settings, student_model_path=str(work / "student"), device="cuda",
                     preload_index_dir=str(work / "index"))
    with live_server(app, "serve") as (port, startup_s):
        state = app.state
        recorded = []  # (input_ids [B, L] numpy, embeddings [B, H]) of each request batch
        forward = state.student.forward_batch

        def recording_forward(batch):
            out = forward(batch)
            recorded.append((batch["input_ids"], out.detach().clone()))
            return out

        state.student.forward_batch = recording_forward
        queries = [" ".join(np.random.default_rng(args.seed + i).choice(WORDS, 6))
                   for i in range(13)]
        requests = [(queries[0], 10)]  # a single query first
        burst = [(q, 10 if i % 2 else 5) for i, q in enumerate(queries[1:9])]
        results = [post(port, "/search", {"query": queries[0], "k": 10})]
        with ThreadPoolExecutor(len(burst)) as pool:  # a concurrent burst
            results += list(pool.map(lambda qk: post(port, "/search",
                                                     {"query": qk[0], "k": qk[1]}), burst))
        requests += burst
        for q in queries[9:]:  # then one at a time
            results.append(post(port, "/search", {"query": q, "k": 10}))
            requests.append((q, 10))
        check(get(port, "/metrics") == 200 and get(port, "/health") == 200, "metrics/health")
        state.student.forward_batch = forward  # stop recording
        loads = [run_load(port, 1000, c, args.seed + c) for c in (1, 32)]
        for load in loads:
            log(f"[serve] closed loop: {json.dumps(load)}")
            check(load["failed"] == 0, f"{load['failed']} of {load['requests']} requests failed")
    # the main path ends here: what follows (breakdown, checks) launches the
    # kernels outside it
    torch.cuda.synchronize()
    counts, tc_counts = launch_counts(), tc_launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] launches on the main path: {counts}; tensor-core routes: {tc_counts}")
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the main path")
    # every L = 512 encode (bf16, head dim 32) went through the tensor-core flash
    check(tc_counts["flash_attn_fwd"] == counts["flash_attn_fwd"],
          f"flash_attn_fwd: {tc_counts['flash_attn_fwd']} of {counts['flash_attn_fwd']} "
          "launches took the tensor-core route")
    # every phase A and phase B of the int8 exact index on the tensor cores
    check(tc_counts["binmax"] == counts["binmax"],
          f"binmax: {tc_counts['binmax']} of {counts['binmax']} "
          "launches took the tensor-core route")
    check(tc_counts["bin_gather"] == counts["bin_gather"],
          f"bin_gather: {tc_counts['bin_gather']} of {counts['bin_gather']} "
          "launches took the tensor-core route")
    times = breakdown(state.fused_searcher, args.seed)
    batch_sizes = [ids_.shape[0] for ids_, _ in recorded]
    check(any(1 < n_real for n_real in _real_rows(recorded, state.student)),
          f"the burst was not merged into one batch: batch rows {batch_sizes}")

    # every response against the plain engine on the embeddings it was served from
    b = state.index_builder
    tok = state.student.tokenizer
    for (q, k), (status, body, _) in zip(requests, results):
        check(status == 200, f"/search {q!r}: HTTP {status} {body}")
        want_ids = [tok.cls_id, *tok.tokenize(state.student.query_prefix + q), tok.sep_id]
        emb_row = None
        for ids_, out in recorded:
            for r in range(ids_.shape[0]):
                if ids_[r, : len(want_ids)].tolist() == want_ids and (
                    len(want_ids) == ids_.shape[1] or ids_[r, len(want_ids)] == tok.pad_id
                ):
                    emb_row = out[r : r + 1]
        check(emb_row is not None, f"no recorded embedding for {q!r}")
        k_bucket = next(kb for kb in K_BUCKETS if k <= kb)
        pv, pi = cosine_topk_core(emb_row, b.device_vectors, k_bucket,
                                  row_scales=b.device_scales, valid_n=b.ntotal)
        want = [f"doc-{i}" for i in pi[0, :k].tolist()]
        got = [r["doc_id"] for r in body["results"]]
        check(got == want, f"/search {q!r}: served {got[:3]}..., plain engine {want[:3]}...")
        scores = [r["score"] for r in body["results"]]
        check(all(math.isfinite(s) for s in scores), "non-finite scores")
    latencies = sorted(r[2] for r in results)
    log(f"[serve] {len(results)} /search responses equal the plain engine's ids; "
        f"client ms: {[round(r[2], 2) for r in results]}; "
        f"server ms: {[round(r[1]['latency_ms'], 2) for r in results]}")

    # recall@10 of the int8 exact search against exact f32 search over the
    # original vectors (corpus-derived probes, as IndexBuilder.validate makes)
    rng = np.random.default_rng(args.seed)
    probes = rng.choice(N_ROWS, 1000, replace=False)
    full = torch.from_numpy(emb).cuda()
    full = full / full.norm(dim=1, keepdim=True)
    noise = torch.from_numpy(rng.normal(0, 0.05, (1000, 384)).astype(np.float32)).cuda()
    pq = full[torch.from_numpy(probes).cuda()] + noise
    pq = pq / pq.norm(dim=1, keepdim=True)
    _, gt = cosine_topk_core(pq, full, 10)
    _, got_idx = b.search(pq.cpu().numpy(), k=10)
    gt = gt.cpu().numpy()
    recall = float(np.mean([len(set(gt[i]) & set(got_idx[i])) / 10 for i in range(1000)]))
    validate = b.validate(n_queries=1000)
    log(f"[serve] recall@10 int8 exact vs f32 original = {recall:.4f}; "
        f"validate() vs dequantized rows = {validate['recall@10']:.4f}")
    check(recall >= 0.97, f"recall@10 {recall} < 0.97")
    return {
        "encode_docs_per_s": docs_per_s,
        "encode_seconds": encode_s,
        "startup_seconds": startup_s,
        "requests": len(results),
        "request_ms": latencies,
        "request_p50_ms": float(np.percentile(latencies, 50)),
        "request_max_ms": latencies[-1],
        "server_latency_ms": [r[1]["latency_ms"] for r in results],
        "batch_rows": batch_sizes,
        "load": loads,
        "breakdown": times,
        "recall_at_10_vs_f32": recall,
        "validate_recall_at_10": validate["recall@10"],
        "peak_device_gib": peak_gib,
        "launches": counts,
        "tc_launches": tc_counts,
        "rows": emb,  # the index's f32 rows, for the sharded phase (not recorded)
    }


def _real_rows(recorded, student) -> list[int]:
    """Rows of each recorded batch that hold a query (not prefix-only padding)."""
    pad_len = len(student.tokenizer.tokenize(student.query_prefix)) + 2
    return [int((ids_[:, pad_len:pad_len + 1] != student.tokenizer.pad_id).sum())
            for ids_, _ in recorded]


# ---------------------------------------------------------------------------
# Phase 4: the KD train path
# ---------------------------------------------------------------------------

SHARDED_BATCHES = (1, 16, 64)
# the kernels of the sharded engines; the query encode (at most 64 tokens,
# below FLASH_MIN_L) launches no flash_attn_fwd, as on the serve path
SHARDED_KERNELS = ("binmax", "bin_gather", "binmax_strided", "cell_gather", "cell_gather_b1")


def phase_sharded(args, emb: np.ndarray) -> dict:
    """Index-sharded search on a one-device CUDA mesh over 1,000,000 x 384
    int8 rows: ShardedIndex.search and ShardedFusedSearcher (the engines'
    kernels per shard, then the merge) against the single-device engines,
    for exact, approx and refine over the serve cell's rows and clustered
    over the clustered phase's saved index (a second cell layout over the
    serve rows would add 35-40 s of host time to a script near its limit),
    at B in SHARDED_BATCHES; each kernel route on the second half of the
    rows at index_offset N/2 against its plain version; two shards on the
    one card against the single-device exact engine; ms per query batch of
    both."""
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.ops.topk import (approx_topk, cosine_topk, cosine_topk_core,
                                         offset_positions, refined_candidates_core,
                                         rescore_candidates)
    from sskd_tpu_torch.ops.topk_cluster import clustered_topk
    from sskd_tpu_torch.parallel.mesh import create_mesh
    from sskd_tpu_torch.serve.fused import FusedSearcher, ShardedFusedSearcher

    work = ROOT / "build" / "chip_smoke"
    ids = [f"doc-{i}" for i in range(N_ROWS)]
    t0 = time.perf_counter()
    builders = {"exact": IndexBuilder(device="cuda").load(work / "index")}
    for name, kw in (("approx", {}), ("refine", {"refine_m": REFINE_M})):
        builders[name] = IndexBuilder(384, index_type="approx", dtype="int8", device="cuda",
                                      **kw).build_from_arrays(emb, ids)
    builders["clustered"] = IndexBuilder(device="cuda").load(work / "clustered_index")
    build_s = time.perf_counter() - t0
    check(builders["exact"].index_type == "exact" and builders["exact"].dtype == "int8"
          and builders["exact"].ntotal == N_ROWS, "the serve phase's index")
    cl = builders["clustered"]
    check((cl.index_type, cl.dtype, cl.ntotal, cl._centroids.shape[0], cl._rows_per_cell,
           cl.nprobe) == ("clustered", "int8", N_ROWS, N_CELLS, CELL_ROWS, NPROBE),
          "the clustered phase's index")
    student = StudentModel(str(work / "student"), device="cuda", compute_dtype=torch.bfloat16)
    texts = distinct_queries(max(SHARDED_BATCHES), args.seed + 41)
    q_emb = student.encode_queries(texts)
    mesh = create_mesh(1, 1)
    check(mesh.devices == ((torch.device("cuda", 0),),), f"mesh {mesh.devices}")

    # the single-device engines first, outside the counted path; the served
    # clustered engine probes cells as the sharded one does
    saved_env = os.environ.get("SSKD_SERVE_CELL_PROBE")
    os.environ["SSKD_SERVE_CELL_PROBE"] = "1"
    try:
        single = {name: {B: (b.search(q_emb[:B], k=10),
                             FusedSearcher(student, b).search_texts(texts[:B], k=10))
                         for B in SHARDED_BATCHES} for name, b in builders.items()}
    finally:
        if saved_env is None:
            os.environ.pop("SSKD_SERVE_CELL_PROBE")
        else:
            os.environ["SSKD_SERVE_CELL_PROBE"] = saved_env

    # --- the sharded path: counts set to 0 before it, read after -----------
    torch.cuda.synchronize()
    reset_launch_counts()
    sharded, got = {}, {}
    for name, b in builders.items():
        sharded[name] = ShardedIndex.from_builder(b, mesh)
        fused = ShardedFusedSearcher(student, sharded[name])
        if name == "exact":
            fused.warmup(max_batch=64, k=10)
        got[name] = {B: (sharded[name].search(q_emb[:B], k=10), fused.search_texts(texts[:B], k=10))
                     for B in SHARDED_BATCHES}
    torch.cuda.synchronize()
    counts, tc_counts = launch_counts(), tc_launch_counts()
    log(f"[sharded] launches on the sharded path: {counts}; tensor-core routes: {tc_counts}")
    for kernel in SHARDED_KERNELS:
        check(counts[kernel] > 0, f"kernel {kernel} was not launched on the sharded path")

    engines = {}
    for name, b in builders.items():
        sh = sharded[name]
        check((sh.n_shards, sh.ntotal) == (1, N_ROWS), f"{name}: {sh.n_shards} shards")
        gaps = []
        for B in SHARDED_BATCHES:
            (sv, si), (fv, fi) = got[name][B]
            (wv, wi), (wfv, wfi) = single[name][B]
            check(np.array_equal(si, wi), f"{name} B={B}: ShardedIndex ids differ from "
                  f"the single-device engine's in {mismatched(si, wi)} places")
            check(np.array_equal(fi, wfi), f"{name} B={B}: ShardedFusedSearcher ids differ "
                  f"from FusedSearcher's in {mismatched(fi, wfi)} places")
            gaps.append(float(max(np.abs(sv - wv).max(), np.abs(fv - wfv).max())))
        check(max(gaps) <= 1e-6, f"{name}: scores {max(gaps)} from the single-device ones")
        q_host = np.asarray(q_emb, dtype=np.float32)
        ms = {f"B={B}": {
            "sharded": time_ms(lambda: sh.search(q_host[:B], k=10), iters=10),
            "single": time_ms(lambda: b.search(q_host[:B], k=10), iters=10)}
            for B in SHARDED_BATCHES}
        engines[name] = {"max_score_gap": max(gaps), "ms_per_batch": ms}
        log(f"[sharded] {name}: ids equal the single-device engine's at B in "
            f"{SHARDED_BATCHES}; ms per batch {json.dumps(ms)}")

    # --- each kernel route at index_offset N/2 against its plain version ----
    half = N_ROWS // 2
    q = torch.from_numpy(np.asarray(q_emb[:16], dtype=np.float32)).cuda()
    offsets = {}
    ex = builders["exact"]
    rows, scales = ex.device_vectors[half:], ex.device_scales[half:]
    valid = N_ROWS - 777  # cuts the last bin of the half
    kv, ki = cosine_topk(q, rows, 10, row_scales=scales, valid_n=valid, index_offset=half)
    pv, pi = cosine_topk_core(q, rows, 10, row_scales=scales, valid_n=valid, index_offset=half)
    offsets["exact"] = (kv, ki, pv, pi)
    ap = builders["approx"]
    kv, ki = approx_topk(q, ap.device_vectors[half:], 10, row_scales=ap.device_scales[half:],
                         valid_n=valid, index_offset=half, kernels=True)
    pv, pi = approx_topk(q, ap.device_vectors[half:], 10, row_scales=ap.device_scales[half:],
                         valid_n=valid, index_offset=half, kernels=False)
    offsets["approx"] = (kv, ki, pv, pi)
    cl = builders["clustered"]
    c0 = cl.device_centroids.shape[0] // 2
    c_off = c0 * cl._rows_per_cell
    for B in (1, 16):
        kw = dict(k=10, nprobe=cl.nprobe, rows_per_cell=cl._rows_per_cell,
                  row_scales=cl.device_scales[c_off:], valid_n=cl.ntotal, index_offset=c_off)
        args_ = (q[:B], cl.device_vectors[c_off:], cl.device_centroids[c0:])
        offsets[f"clustered B={B}"] = (*clustered_topk(*args_, kernels=True, **kw),
                                       *clustered_topk(*args_, kernels=False, **kw))
    rf = builders["refine"]
    ref_rows, ref_scales, ref_bf16 = (rf.device_vectors[half:], rf.device_scales[half:],
                                      rf.device_refine[half:])
    refined = []
    for kernels in (True, False):
        _, cand = refined_candidates_core(q, ref_rows, REFINE_M, row_scales=ref_scales,
                                          valid_n=valid - half, kernels=kernels)
        v, i = rescore_candidates(q, ref_bf16, cand, 10)
        refined += [v, offset_positions(i, half)]
    offsets["refine"] = tuple(refined)
    offset_record = {}
    for name, (kv, ki, pv, pi) in offsets.items():
        ki, pi = ki.cpu().numpy(), pi.cpu().numpy()
        err = float((kv - pv).abs().max())
        # the exact engine against the blocked plain engine within the kernel
        # phase's 1e-5; the others against their own plain versions, int8 bit for bit
        tol = 1e-5 if name == "exact" else 0.0
        lo, hi = (c_off, N_ROWS) if name.startswith("clustered") else (half, valid)
        check(np.array_equal(ki, pi), f"offset {name}: kernel ids differ from the plain "
              f"version's in {mismatched(ki, pi)} places")
        check(((ki == -1) | ((ki >= lo) & (ki < hi))).all(),
              f"offset {name}: ids outside the shard's valid rows [{lo}, {hi})")
        check(err <= tol, f"offset {name}: scores {err} from the plain version's")
        offset_record[name] = {"max_abs_err": err, "ids_equal": True}
    log(f"[sharded] every route at index_offset {half} gives the plain version's ids and "
        f"scores: {sorted(offset_record)}")

    # --- the one-device exact index saved as sskd-sharded-1, for the
    # distributed phase's ranks, each of which loads its own half ------------
    t0 = time.perf_counter()
    sharded["exact"].save(work / "sharded_index")
    save_s = time.perf_counter() - t0

    # --- two shards on the one card: the sharded exact engine's merge -------
    mesh2 = create_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2)
    two = ShardedIndex.from_builder(ex, mesh2)
    for B in SHARDED_BATCHES:
        tv, ti = two.search(q_emb[:B], k=10)
        (wv, wi), _ = single["exact"][B]
        check(np.array_equal(ti, wi), f"two shards B={B}: ids differ from the single-device "
              f"engine's in {mismatched(ti, wi)} places")
    two_ms = {f"B={B}": time_ms(lambda: two.search(np.asarray(q_emb[:B]), k=10), iters=10)
              for B in SHARDED_BATCHES}
    log(f"[sharded] two shards on one card ({two.rows_per_shard} rows each): the "
        f"single-device exact ids; ms per batch {json.dumps(two_ms)}")
    del sharded, two, builders
    # the queries and the single-device results, for the distributed phase (not recorded)
    reference = {"queries": np.asarray(q_emb, dtype=np.float32),
                 "exact": {B: single["exact"][B][0] for B in SHARDED_BATCHES},
                 "clustered": {B: single["clustered"][B][0] for B in SHARDED_BATCHES}}
    return {"build_seconds": build_s, "engines": engines, "offset_checks": offset_record,
            "two_shards_ms_per_batch": two_ms, "launches": counts, "tc_launches": tc_counts,
            "save_seconds": save_s, "reference": reference}


TRAIN_QUERIES = 512  # 16 steps of 32 queries x 8 docs
LONG_DOC_STEPS = 4  # the run at doc_len 512: 4 steps of 32 queries x 8 docs


def make_kd_samples(n: int, n_docs: int, seed: int, doc_words: tuple = (40, 160)) -> list:
    """Seeded synthetic KD samples over WORDS: a 6-12 word query, a positive
    that repeats the query's words, and n_docs - 1 negatives; docs of
    ``doc_words`` words (40-160 by default, some past doc_len 192 tokens);
    teacher scores 5 + noise for the positive, sorted uniforms in (-5, 0)
    for the negatives."""
    from sskd_tpu_torch.kd.dataset import KDSample

    lo, hi = doc_words
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n):
        query = list(rng.choice(WORDS, rng.integers(6, 13)))
        pos = query * 3 + list(rng.choice(WORDS, rng.integers(lo - 20, hi - 30)))
        negs = [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1))) for _ in range(n_docs - 1)]
        scores = [5.0 + float(rng.normal(0, 0.5))] + sorted(
            rng.uniform(-5, 0, n_docs - 1).tolist(), reverse=True)
        samples.append(KDSample(query=" ".join(query), docs=[" ".join(pos)] + negs,
                                teacher_scores=scores))
    return samples


# Adam's |m_hat / sqrt(v_hat)| at its second step (b1 0.9, b2 0.999), for any
# two gradients g1, g2: |b1 g1 + g2| / (1 + b1) over sqrt((b2 g1^2 + g2^2) /
# (1 + b2)), at most sqrt(b1^2 / b2 + 1) sqrt(1 + b2) / (1 + b1) by
# Cauchy-Schwarz
ADAM_STEP2_MAX = math.sqrt(0.9**2 / 0.999 + 1) * math.sqrt(1.999) / 1.9


def param_motion(before: dict, after: dict, lr: float, wd: float) -> dict:
    """How far one AdamW update at Adam's second step, learning rate ``lr``,
    moved each f32 parameter, against what the update allows: |dp| <= lr
    (ADAM_STEP2_MAX + wd |p|), with 1e-5 of the first term for the f32
    roundings inside Adam's ratio (about ten, 6e-7) and one f32 rounding of
    p in each of the update's two in-place ops. The bound is tight: the
    ratio reaches ADAM_STEP2_MAX where g1 = (b1 / b2) g2. ``share_moved``:
    the share of the encoder layers' elements that moved by at least lr / 10."""
    worst, top, moved, n_layer = 0.0, 0.0, 0, 0
    for name, p0 in before.items():
        dp = (after[name] - p0).abs()
        allowed = (lr * (ADAM_STEP2_MAX * (1 + 1e-5) + wd * p0.abs())
                   + 2.0**-23 * (p0.abs() + lr) + 1e-12)
        worst = max(worst, (dp / allowed).max().item())
        top = max(top, dp.max().item() / lr)
        if name.startswith("encoder.layers."):
            moved += int((dp >= 0.1 * lr).sum().item())
            n_layer += dp.numel()
    return {"max_dp_over_allowed": worst, "max_dp_over_lr": top,
            "share_moved": moved / max(1, n_layer)}


class PlainDropoutAttention(torch.autograd.Function):
    """dropout_attention over the plain pair, dropattn_fwd_plain and
    dropattn_bwd_plain: the kernels' arithmetic with no kernel launched.
    With ``compute`` f32 it runs the same without the bf16 roundings inside
    (inputs and results still in the caller's type)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, p, seed, compute):
        from sskd_tpu_torch.ops import attention as ta

        qc, kc, vc = (t.to(compute) for t in (q, k, v))
        bias = bias.detach().float()
        out, lse = ta.dropattn_fwd_plain(qc, kc, vc, bias, p, seed)
        ctx.save_for_backward(qc, kc, vc, bias, lse)
        ctx.p, ctx.seed = p, seed
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        from sskd_tpu_torch.ops import attention as ta

        qc, kc, vc, bias, lse = ctx.saved_tensors
        grads = ta.dropattn_bwd_plain(qc, kc, vc, bias, ctx.p, ctx.seed, lse, g.to(qc.dtype))
        return (*(t.to(g.dtype) for t in grads), None, None, None, None)


def step_grads(trainer, batch, compute=None, pinned=None) -> torch.Tensor:
    """Every parameter's gradient (flat, f32) of one train step on ``batch``
    at fixed progress and seeds: the trainer's own forward, loss and
    backward, without the update. ``compute`` None runs the dropattn
    kernels; a dtype swaps in PlainDropoutAttention computing in it.

    ``pinned`` (a dict) fixes where Margin-MSE takes each row's max: the
    first call on it records the argmax of every ``_masked_max`` of the step
    (``pinned["index"]``), later calls take the max at those indices, the
    same function with the same subgradient, and count in
    ``pinned["moved"]`` the rows whose own argmax lies elsewhere."""
    from sskd_tpu_torch.kd import losses
    from sskd_tpu_torch.models import bert

    module = trainer.student.module
    masked_max = losses._masked_max
    calls = []

    def pinned_max(x, mask):
        masked = torch.where(mask > 0, x, losses._NEG)
        own = masked.argmax(dim=-1, keepdim=True)
        index = pinned.setdefault("index", [])
        if len(calls) == len(index):
            index.append(own)
        at = index[len(calls)]
        pinned["moved"] = pinned.get("moved", 0) + int((own != at).sum())
        calls.append(at)
        return masked.gather(-1, at)

    class NoUpdate:
        def begin(self):
            module.zero_grad(set_to_none=True)

        def step(self):
            pass

    saved = trainer._opt, bert.dropout_attention
    trainer._opt = NoUpdate()
    if compute is not None:
        bert.dropout_attention = (
            lambda q, k, v, bias, p, seed: PlainDropoutAttention.apply(q, k, v, bias, p, seed,
                                                                        compute))
    if pinned is not None:
        losses._masked_max = pinned_max
    try:
        trainer._prepare_module()
        trainer._train_step(batch, 0.5, 11)
        grads = torch.cat([p.grad.detach().float().flatten() for p in module.parameters()
                           if p.grad is not None])
    finally:
        trainer._opt, bert.dropout_attention = saved
        losses._masked_max = masked_max
        module.zero_grad(set_to_none=True)
        module.eval()
        module.encoder.remat = None
    return grads


def phase_train(args) -> dict:
    import tempfile

    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.kd.dataset import KDDataset
    from sskd_tpu_torch.kd.train import KDTrainer
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts

    batch, n_docs, query_len, doc_len = 32, 8, 64, 192
    samples = make_kd_samples(TRAIN_QUERIES, n_docs, args.seed)
    settings = Settings.from_dict({"training": {
        "epochs": 1, "batch_size": batch, "learning_rate": 2e-5, "weight_decay": 0.01,
        "warmup_ratio": 0.1, "max_grad_norm": 1.0, "num_docs_per_query": n_docs,
        "remat": True, "remat_policy": "full", "resume": False, "seed": args.seed,
    }})
    student = StudentModel("intfloat/e5-small-v2", device="cuda", compute_dtype=torch.bfloat16,
                           seed=args.seed)
    cfg = student.config
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.intermediate_size,
           cfg.vocab_size) == (384, 12, 12, 1536, 30522), "not e5-small-v2 width")
    check(cfg.hidden_dropout == 0.1 and cfg.attention_dropout == 0.1, "dropout is not 0.1")
    check({p.dtype for p in student.module.parameters()} == {torch.float32}, "params not f32")
    trainer = KDTrainer(student, settings)
    inner = trainer._train_step
    starts, events, step_aux, snaps, motion = [], [], [], [], {}

    def snapshot():
        return {n: p.detach().clone() for n, p in student.module.named_parameters()}

    def timed_step(batch_, progress, step_seed):
        # Each step between two CUDA events, read after the run, and its host
        # start time: train()'s own loop, with no host sync added from step 3
        # on. Steps 1 and 2 also between parameter snapshots, outside the
        # events, compared (with syncs) before step 3 starts.
        i = len(events)
        if i < 2:
            snaps.append(snapshot())
        elif i == 2:  # the snapshots are freed: the peak counts steps 3 on
            torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        starts.append(time.perf_counter())
        start.record()
        aux = inner(batch_, progress, step_seed)
        end.record()
        events.append((start, end))
        step_aux.append(aux)
        if i == 1:
            snaps.append(snapshot())
            # the first update's lr is schedule(0) = 0: the parameters stay
            # as they were; the second moves them, within AdamW's bound
            motion["step1_unchanged"] = all(torch.equal(snaps[0][n], snaps[1][n])
                                            for n in snaps[0])
            motion.update(param_motion(snaps[1], snaps[2], trainer._opt.schedule(1),
                                       settings.training.weight_decay))
            snaps.clear()
        return aux

    trainer._train_step = timed_step
    with tempfile.TemporaryDirectory(prefix="sskd_train_") as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = trainer.train(samples, output_dir=out_dir, query_len=query_len, doc_len=doc_len)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        # the train path ends here: what follows launches outside it
        counts, tc_counts = launch_counts(), tc_launch_counts()
        trainer._train_step = inner
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steps = result["global_step"]
        log(f"[train] {steps} steps in {train_s:.1f} s; launches on the train path: {counts}")
        check(steps == TRAIN_QUERIES // batch, f"{steps} steps, want {TRAIN_QUERIES // batch}")
        step_losses = [{k: float(v) for k, v in aux.items()} for aux in step_aux]
        for i, aux in enumerate(step_losses):
            check(all(math.isfinite(x) for x in aux.values()), f"step {i}: non-finite {aux}")
        check(math.isfinite(result["history"][0]["train_loss"]), "non-finite epoch loss")
        event_ms = [a.elapsed_time(b) for a, b in events]
        # the loop's cadence: host time from one step's start to the next
        cadence_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]

        log(f"[train] steps 1 and 2 moved the parameters: {json.dumps(motion)}")
        check(motion["step1_unchanged"], "step 1 changed the parameters (its learning rate is 0)")
        check(motion["max_dp_over_allowed"] <= 1.0, f"step 2 moved a parameter too far: {motion}")
        check(motion["max_dp_over_lr"] >= 0.5 and motion["share_moved"] >= 0.5,
              f"step 2 did not move the parameters by about lr: {motion}")
        # per step: 12 layers x 2 towers forward, again in the remat recompute,
        # and 12 x 2 backward
        towers = 2 * cfg.num_layers
        check(counts["dropattn_fwd"] == steps * 2 * towers,
              f"dropattn_fwd launches {counts['dropattn_fwd']}, want {steps * 2 * towers}")
        check(counts["dropattn_bwd"] == steps * towers,
              f"dropattn_bwd launches {counts['dropattn_bwd']}, want {steps * towers}")
        # every forward and backward of both towers (L = 64 and 192, bf16) on
        # the tensor cores
        check(tc_counts["dropattn_fwd"] == counts["dropattn_fwd"],
              f"dropattn_fwd: {tc_counts['dropattn_fwd']} of {counts['dropattn_fwd']} "
              "launches took the tensor-core route")
        check(tc_counts["dropattn_bwd"] == counts["dropattn_bwd"],
              f"dropattn_bwd: {tc_counts['dropattn_bwd']} of {counts['dropattn_bwd']} "
              "launches took the tensor-core route")

        best = StudentModel(str(Path(out_dir) / "best_model"), device="cuda",
                            compute_dtype=torch.bfloat16)
        emb = best.encode_queries([s.query for s in samples[:64]])
        check(emb.shape == (64, 384) and np.isfinite(emb).all(), "best_model encode")
        check(np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3), "not unit norm")
        trained = dict(student.module.named_parameters())
        check(all(torch.equal(p, trained[n].detach())
                  for n, p in best.module.named_parameters()), "best_model differs")
        del best

        # device busy share over a few more steps (outside the counted path)
        ds = KDDataset(samples[:batch * 3], student.tokenizer, num_docs=n_docs,
                       query_len=query_len, doc_len=doc_len)
        t0 = time.perf_counter()
        packed = list(ds.batches(batch, shuffle=False))
        pack_ms = (time.perf_counter() - t0) * 1e3 / len(packed)
        trainer._prepare_module()
        inner(packed[0], 0.5, 7)
        # the same steps with the batches packed beforehand, so no
        # tokenization runs beside them: unprofiled, then profiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, b in enumerate(packed):
            inner(b, 0.5, 8 + i)
        torch.cuda.synchronize()
        prepacked_ms = (time.perf_counter() - t0) * 1e3 / len(packed)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i, b in enumerate(packed):
                inner(b, 0.5, 8 + i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        student.module.eval()
        by_kernel = device_times(prof)
        busy_us = sum(t for _, t in by_kernel)

    # One step's gradients through the kernels against the same step over
    # the plain pair (same masks by construction), at the trained weights.
    # In bf16 any difference, however small, flips later bf16 roundings
    # through the twelve layers, so the two land about 1 % apart whatever
    # its source; the yardstick is the plain pair computing in f32 inside,
    # whose distance from the bf16 plain pair is what rounding the attention
    # to bf16 does to these gradients. The same step in f32 compute (the
    # kernels' f32 routes, three TF32 products a product) cascades no
    # rounding: there the kernels and the plain pair differ by about 2^-21
    # of each product and f32 summation order, which the step
    # keeps far below 1e-3 of the gradient's norm, while a mask, seed or
    # bias that a recompute or the backward got wrong moves it by percents.
    # The bf16 distances are taken over the gradients of all three pre-packed
    # batches at once. Margin-MSE subtracts each row's max student score,
    # whose gradient goes to the argmax doc alone; the random-init student
    # scores a query's docs about 1e-3 apart, less than bf16 rounding moves
    # them, so any perturbation (a constant added to the bias, the plain pair
    # in f32, the kernels) can move some row's argmax, which moves 7-23 % of
    # the gradient's norm at once. Every run of a batch therefore takes the
    # max where the plain run found it (in the f32 step too): the same loss,
    # the same subgradient, and a comparison of the attention's arithmetic
    # alone.
    grad_check = grads_vs_plain(trainer, packed)
    g_norm = grad_check["grad_norm"]
    student32 = StudentModel("intfloat/e5-small-v2", device="cuda", compute_dtype=torch.float32,
                             seed=args.seed)
    student32.module.load_state_dict(student.module.state_dict())
    trainer32 = KDTrainer(student32, settings)
    pinned = {}
    g_plain = step_grads(trainer32, packed[0], torch.float32, pinned)
    g_kernel = step_grads(trainer32, packed[0], None, pinned)
    grad_check["f32_max_rows_moved"] = pinned["moved"]
    grad_check["f32_grad_norm"] = g_plain.norm().item()
    grad_check["f32_kernel_vs_plain_rel"] = ((g_kernel - g_plain).norm().item()
                                             / grad_check["f32_grad_norm"])
    del g_kernel, g_plain, student32, trainer32
    log(f"[train] one step's gradients, kernels vs plain pair: {json.dumps(grad_check)}")
    check(all(math.isfinite(x) for x in grad_check.values()) and g_norm > 0,
          f"gradients not finite: {grad_check}")
    check(grad_check["kernel_vs_plain_rel"] <= grad_check["bf16_noise_rel"],
          f"kernel gradients farther from the plain pair than bf16 noise: {grad_check}")
    check(grad_check["f32_kernel_vs_plain_rel"] <= 1e-3,
          f"f32 step: kernel gradients differ from the plain pair's: {grad_check}")
    steady = sorted(cadence_ms[2:]) or cadence_ms
    ms_step = float(np.median(steady))
    record = {
        "steps": steps,
        "train_seconds": train_s,
        # host time from each step's start to the next: the loop's pace
        "step_cadence_ms": cadence_ms,
        # device time between events around each step (excludes the host's
        # wait for the next batch)
        "step_event_ms": event_ms,
        "event_ms_median": float(np.median(sorted(event_ms[2:]) or event_ms)),
        "ms_per_step_median": ms_step,
        "samples_per_s": batch / (ms_step / 1e3),
        "docs_per_s": batch * n_docs / (ms_step / 1e3),
        "peak_device_gib": peak_gib,  # steps 3 on, the epoch's end included
        "param_motion": motion,
        "grad_check": grad_check,
        "device_busy_share": busy_us / wall_us if busy_us > 0 else None,
        "pack_ms_per_batch": pack_ms,  # host tokenization + padding of one batch
        # pre-packed batches, so no tokenization runs: unprofiled, profiled
        "prepacked_ms_per_step": prepacked_ms,
        "window_ms_per_step": wall_us / 1e3 / len(packed),
        "device_ms_per_step": busy_us / 1e3 / len(packed),
        "top_kernels_ms_per_step": [(k, t / 1e3 / len(packed)) for k, t in by_kernel[:25]],
        "losses": [a["loss"] for a in step_losses],
        "history": result["history"],
        "launches": counts,
        "tc_launches": tc_counts,
    }
    log(f"[train] {json.dumps({k: v for k, v in record.items() if k not in ('history',)})}")
    record["doc_len_512"] = train_long_docs(args, student, settings)
    return record


def grads_vs_plain(trainer, batches) -> dict:
    """One step's gradients through the kernels against the same step over
    the plain pair in bf16 and in f32 compute, over ``batches`` at once, the
    argmax of Margin-MSE pinned where the plain run found it (phase_train's
    check: the kernels no farther from the bf16 plain pair than bf16
    rounding of the attention moves it)."""
    g_kernel, g_plain, g_plain32, moved = [], [], [], 0
    for b in batches:
        pinned: dict = {}
        g_plain.append(step_grads(trainer, b, torch.bfloat16, pinned))
        g_kernel.append(step_grads(trainer, b, None, pinned))
        g_plain32.append(step_grads(trainer, b, torch.float32, pinned))
        moved += pinned["moved"]
    g_kernel, g_plain, g_plain32 = (torch.cat(g) for g in (g_kernel, g_plain, g_plain32))
    g_norm = g_plain.norm().item()
    return {
        "grad_norm": g_norm, "batches": len(batches), "max_rows_moved": moved,
        "kernel_vs_plain_rel": (g_kernel - g_plain).norm().item() / g_norm,
        "bf16_noise_rel": (g_plain32 - g_plain).norm().item() / g_norm,
        "cosine_kernel_plain": F.cosine_similarity(g_kernel, g_plain, dim=0).item(),
    }


def train_long_docs(args, student, settings) -> dict:
    """KDTrainer.train at doc_len 512 (the length configs/kd.yaml encodes
    passages at, max_seq_length and chunk_max_tokens) and query_len 64, the
    trained student of phase_train going on, batch 32 x 8 docs of 300-480
    words, bf16, remat full, LONG_DOC_STEPS steps: every loss finite, the
    dropattn launches the code implies, every doc-tower backward (L = 512)
    on the streaming route and every query-tower one (L = 64) on the
    resident one; ms per step and peak memory; then one step's gradients
    through the kernels against the plain pair's at 4 queries x 8 docs
    (three batches), within bf16 rounding's distance."""
    import tempfile

    from sskd_tpu_torch.kd.dataset import KDDataset
    from sskd_tpu_torch.kd.train import KDTrainer
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.ops import attention as ta

    batch, n_docs, query_len, doc_len = 32, 8, 64, 512
    cfg = student.config
    samples = make_kd_samples(batch * LONG_DOC_STEPS, n_docs, args.seed + 1, doc_words=(300, 480))
    routes = {L: ta.dropattn_bwd_route(torch.bfloat16, cfg.hidden_size // cfg.num_heads, L)
              for L in (query_len, doc_len)}
    check(routes == {query_len: "tc", doc_len: "tc_stream"}, f"doc_len 512 routes {routes}")
    trainer = KDTrainer(student, settings)
    inner = trainer._train_step
    events, starts, losses = [], [], []

    def timed_step(batch_, progress, step_seed):
        if len(events) == 1:  # the peak counts steps 2 on
            torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        starts.append(time.perf_counter())
        start.record()
        aux = inner(batch_, progress, step_seed)
        end.record()
        events.append((start, end))
        losses.append(aux)
        return aux

    trainer._train_step = timed_step
    with tempfile.TemporaryDirectory(prefix="sskd_train512_") as out_dir:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = trainer.train(samples, output_dir=out_dir, query_len=query_len,
                               doc_len=doc_len)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        # the run ends here: what follows launches outside it
        counts, tc_counts = launch_counts(), tc_launch_counts()
        stream = ta.dropattn_bwd.stream_launches
        trainer._train_step = inner
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = result["global_step"]
    log(f"[train] doc_len 512: {steps} steps in {train_s:.1f} s; launches {counts}, "
        f"tensor-core {tc_counts}, streaming dropattn_bwd {stream}")
    check(steps == LONG_DOC_STEPS, f"doc_len 512: {steps} steps, want {LONG_DOC_STEPS}")
    step_losses = [{k: float(v) for k, v in aux.items()} for aux in losses]
    check(all(math.isfinite(x) for aux in step_losses for x in aux.values()),
          f"doc_len 512: non-finite losses {step_losses}")
    layers = cfg.num_layers
    # a step: each tower's 12 layers forward, again in the remat recompute, and backward
    check(counts["dropattn_fwd"] == steps * 2 * 2 * layers
          and counts["dropattn_bwd"] == steps * 2 * layers,
          f"doc_len 512: dropattn launches {counts}, want {steps * 4 * layers} forward and "
          f"{steps * 2 * layers} backward")
    check(tc_counts["dropattn_bwd"] == counts["dropattn_bwd"] and stream == steps * layers,
          f"doc_len 512: {tc_counts['dropattn_bwd']} tensor-core and {stream} streaming "
          f"dropattn_bwd launches of {counts['dropattn_bwd']}; want every doc-tower backward "
          f"({steps * layers}) streaming and every query-tower one resident")
    event_ms = [a.elapsed_time(b) for a, b in events]
    cadence_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    ds = KDDataset(samples[:12], student.tokenizer, num_docs=n_docs, query_len=query_len,
                   doc_len=doc_len)
    small = list(ds.batches(4, shuffle=False))
    grad_check = grads_vs_plain(trainer, small)
    log(f"[train] doc_len 512, one step's gradients, kernels vs plain pair: "
        f"{json.dumps(grad_check)}")
    check(all(math.isfinite(x) for x in grad_check.values()) and grad_check["grad_norm"] > 0,
          f"doc_len 512: gradients not finite: {grad_check}")
    check(grad_check["kernel_vs_plain_rel"] <= grad_check["bf16_noise_rel"],
          f"doc_len 512: kernel gradients farther from the plain pair than bf16 noise: "
          f"{grad_check}")
    ms_step = float(np.median(event_ms[1:]))
    record = {
        "steps": steps, "batch": batch, "docs": n_docs, "query_len": query_len,
        "doc_len": doc_len, "train_seconds": train_s, "step_event_ms": event_ms,
        "step_cadence_ms": cadence_ms, "event_ms_median": ms_step,
        "samples_per_s": batch / (ms_step / 1e3), "peak_device_gib": peak_gib,
        "losses": [a["loss"] for a in step_losses], "launches": counts,
        "tc_launches": tc_counts, "stream_launches": stream, "routes": routes,
        "grad_check": grad_check,
    }
    log(f"[train] doc_len 512: {json.dumps(record)}")
    return record


# ---------------------------------------------------------------------------
# Phase 5: the clustered (cell-probe) path
# ---------------------------------------------------------------------------


class TopicalData:
    """The low-intrinsic-dimension "topical" recipe: 1,000 topic centres in 32
    dimensions, a row = its topic + 0.3 N(0, I), mapped to ``dim`` by a fixed
    random matrix over sqrt(32), + 0.02 N(0, I), normalised. Uniform random
    rows have no cluster structure for a cell probe to prune."""

    def __init__(self, seed: int, dim: int = 384, intrinsic: int = 32, topics: int = 1000):
        self.rng = np.random.default_rng(seed)
        self.a_map = (self.rng.standard_normal((intrinsic, dim)) / np.sqrt(intrinsic)).astype(
            np.float32)
        self.topic = self.rng.standard_normal((topics, intrinsic)).astype(np.float32)

    def rows(self, n: int) -> np.ndarray:
        out = []
        for i in range(0, n, 250_000):
            m = min(250_000, n - i)
            z = self.topic[self.rng.integers(0, len(self.topic), m)] + 0.3 * (
                self.rng.standard_normal((m, self.topic.shape[1])).astype(np.float32))
            x = z @ self.a_map + 0.02 * self.rng.standard_normal(
                (m, self.a_map.shape[1])).astype(np.float32)
            x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            out.append(x.astype(np.float32))
        return np.concatenate(out)


def mismatched(got: np.ndarray, want: np.ndarray) -> int:
    return int((np.asarray(got) != np.asarray(want)).sum())


def distinct_queries(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    seen: dict[str, None] = {}
    while len(seen) < n:
        seen[" ".join(rng.choice(WORDS, 8))] = None
    return list(seen)


def serve_and_record(app, tag: str, sequential: list[str], concurrent: list[str],
                     clients: int, load_seed: int | None) -> dict:
    """Serve ``app``; send ``sequential`` one request at a time from one
    client and ``concurrent`` from ``clients`` closed-loop clients (threads of
    this process, every response kept), recording each batch the student
    embedded; then, if asked, closed-loop load from a client process."""
    with live_server(app, tag) as (port, startup_s):
        state = app.state
        recorded = []
        forward = state.student.forward_batch

        def recording_forward(batch):
            out = forward(batch)
            recorded.append((batch["input_ids"], out.detach().clone()))
            return out

        state.student.forward_batch = recording_forward

        def client(queries):
            return [post(port, "/search", {"query": q, "k": 10}) for q in queries]

        results = client(sequential)
        with ThreadPoolExecutor(clients) as pool:
            for part in pool.map(client, [concurrent[i::clients] for i in range(clients)]):
                results += part
        requests = sequential + [q for i in range(clients) for q in concurrent[i::clients]]
        state.student.forward_batch = forward
        loads = []
        if load_seed is not None:
            loads = [run_load(port, 500, c, load_seed + c) for c in (1, 32)]
            for load in loads:
                log(f"[{tag}] closed loop: {json.dumps(load)}")
                check(load["failed"] == 0, f"{load['failed']} requests failed")
    return {"startup_s": startup_s, "recorded": recorded, "requests": requests,
            "results": results, "loads": loads}


def check_served(served: dict, state, plain_engine, tag: str) -> dict:
    """Every response of ``served`` against ``plain_engine(embeddings [B, H])
    -> (vals, original positions)`` run on the whole batch it was served
    from (the same batch, so the same kernel's arithmetic)."""
    tok, st = state.student.tokenizer, state.student
    where = {}
    for i, (ids_, _) in enumerate(served["recorded"]):
        for r in range(ids_.shape[0]):
            row = ids_[r].tolist()
            while row and row[-1] == tok.pad_id:
                row.pop()
            where[tuple(row)] = (i, r)
    plain = {}
    bad = 0
    for q, (status, body, _) in zip(served["requests"], served["results"]):
        check(status == 200, f"[{tag}] /search {q!r}: HTTP {status} {body}")
        key = (tok.cls_id, *tok.tokenize(st.query_prefix + q), tok.sep_id)
        check(key in where, f"[{tag}] no recorded embedding for {q!r}")
        i, r = where[key]
        if i not in plain:
            plain[i] = plain_engine(served["recorded"][i][1])
        vals, pos = plain[i]
        want = [f"doc-{p}" for p in pos[r, :10].tolist()]
        got = [x["doc_id"] for x in body["results"]]
        scores = [x["score"] for x in body["results"]]
        check(all(math.isfinite(v) for v in scores), f"[{tag}] non-finite scores")
        bad += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        check(np.allclose(scores, vals[r, : len(scores)], rtol=1e-6, atol=1e-7),
              f"[{tag}] /search {q!r}: scores differ from the plain engine's")
    batches = [ids_.shape[0] for ids_, _ in served["recorded"]]
    check(bad == 0, f"[{tag}] {bad} served ids differ from the plain engine's")
    ms = sorted(r[2] for r in served["results"])
    log(f"[{tag}] {len(served['results'])} /search responses equal the plain engine's; "
        f"batch rows seen: {sorted(set(batches))}; client ms p50 {np.percentile(ms, 50):.2f} "
        f"max {ms[-1]:.2f}")
    return {"requests": len(served["results"]), "mismatched_ids": bad,
            "batch_rows": sorted(set(batches)), "n_batches": len(batches),
            "request_p50_ms": float(np.percentile(ms, 50)), "request_max_ms": ms[-1],
            "startup_seconds": served["startup_s"], "load": served["loads"]}


def clustered_parts_ms(b, queries: torch.Tensor) -> dict:
    """Device ms of the steps of one clustered search (CUDA events, a
    rotation of query sets): probe, query quantization, cell scores, the mask
    and the top-k over the probed rows."""
    from sskd_tpu_torch.ops import topk_cluster as tc
    from sskd_tpu_torch.ops import topk_kernels as tk

    B = queries[0].shape[0]
    rpc, n = b._rows_per_cell, b.ntotal
    nprobe = min(b.nprobe, b.device_centroids.shape[0])

    def probe_of(q):
        return tk.topk_stable(q @ b.device_centroids.T, nprobe)[1].to(torch.int32).contiguous()

    staged = []
    for q in queries:
        probe = probe_of(q)
        q_in, q_scale = tk.quantize_queries(q, b.device_vectors)
        gather = tc.cell_gather_b1 if B == 1 else tc.cell_gather
        scores = gather(q_in, q_scale, b.device_vectors, b.device_scales, probe, rpc,
                        check_probe=False)
        staged.append((q, probe, q_in, q_scale, scores))
    lane = torch.arange(rpc, device="cuda", dtype=torch.int32)

    def extract(q, probe, q_in, q_scale, scores):
        gidx = (probe[:, :, None] * rpc + lane).reshape(B, -1)
        flat = torch.where(gidx < n, scores.reshape(B, -1), tc.NEG_INF)
        vals, pos = tc.flat_topk(flat, 10)
        return vals, torch.gather(gidx, 1, pos)

    return {
        "probe_ms": time_ms(rotating(lambda q, *_: probe_of(q), staged), 20),
        "quantize_ms": time_ms(
            rotating(lambda q, *_: tk.quantize_queries(q, b.device_vectors), staged), 20),
        "cell_scores_ms": time_ms(
            rotating(lambda q, probe, q_in, q_scale, _: gather(
                q_in, q_scale, b.device_vectors, b.device_scales, probe, rpc,
                check_probe=False), staged), 20),
        "extract_ms": time_ms(rotating(extract, staged), 20),
    }


TOPICAL_QUERIES = 1000 + 8 + 16 + 64 + 256 + 4  # recall probes, then the batches


def topical_corpus(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The clustered and refine phases' seeded corpus: N_ROWS topical rows and
    TOPICAL_QUERIES topical queries, made once and shared by both phases."""
    data = TopicalData(seed + 5)
    t0 = time.perf_counter()
    emb = data.rows(N_ROWS)
    queries = data.rows(TOPICAL_QUERIES)
    log(f"[topical] {N_ROWS} rows and {TOPICAL_QUERIES} queries in "
        f"{time.perf_counter() - t0:.1f} s")
    return emb, queries


def phase_clustered(args, emb: np.ndarray, queries: np.ndarray) -> dict:
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.ops.topk import approx_topk, cosine_topk
    from sskd_tpu_torch.ops.topk_cluster import CLUSTER_MAX_BATCH, clustered_topk
    from sskd_tpu_torch.serve.app import create_app

    work = ROOT / "build" / "chip_smoke"
    ids = [f"doc-{i}" for i in range(N_ROWS)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the clustered path starts here

    t0 = time.perf_counter()
    built = IndexBuilder(384, index_type="clustered", dtype="int8", nprobe=NPROBE, device="cuda")
    built.build_from_arrays(emb, ids)
    build_s = time.perf_counter() - t0
    check((built._centroids.shape[0], built._rows_per_cell) == (N_CELLS, CELL_ROWS),
          f"cells {built._centroids.shape[0]} x {built._rows_per_cell}")
    t0 = time.perf_counter()
    built.save(work / "clustered_index")
    b = IndexBuilder(device="cuda").load(work / "clustered_index")
    save_load_s = time.perf_counter() - t0
    check(b.index_type == "clustered" and b.nprobe == NPROBE and b.ntotal == N_ROWS
          and np.array_equal(b._perm, built._perm), "the loaded index differs from the built one")
    del built
    log(f"[clustered] built {N_CELLS} cells x {CELL_ROWS} rows in {build_s:.1f} s on the host, "
        f"saved and loaded in {save_load_s:.1f} s")

    # --- the library entry: IndexBuilder.search at each batch size -----------
    q_val, rest = queries[:1000], queries[1000:]
    batches = [rest[i:i + 1] for i in range(8)] + [rest[8:24], rest[24:88], rest[88:344]]
    library = [b.search(q, k=10) for q in batches]

    # --- the served entry ----------------------------------------------------
    student_dir = work / "student"
    if not (student_dir / "sskd_config.json").exists():
        StudentModel("intfloat/e5-small-v2", device="cuda", compute_dtype=torch.bfloat16,
                     seed=args.seed).save(student_dir)
    settings = Settings.from_dict({
        "service": {"micro_batch_window_ms": 5.0, "micro_batch_max_size": 64},
    })  # index.search_method stays at its default: the index's own type is served

    def make_app():
        return create_app(settings, student_model_path=str(student_dir), device="cuda",
                          preload_index_dir=str(work / "clustered_index"))

    texts = distinct_queries(32 + 256 + 8 + 32, args.seed + 9)
    saved_env = os.environ.get("SSKD_SERVE_CELL_PROBE")
    os.environ["SSKD_SERVE_CELL_PROBE"] = "1"
    try:
        app_probe = make_app()
        before = launch_counts()["cell_gather"]
        served_probe = serve_and_record(app_probe, "clustered", texts[:32], texts[32:288], 32,
                                        args.seed + 100)
        probe_launches = launch_counts()["cell_gather"] - before
    finally:
        if saved_env is None:
            del os.environ["SSKD_SERVE_CELL_PROBE"]
        else:
            os.environ["SSKD_SERVE_CELL_PROBE"] = saved_env
    app_sweep = make_app()  # the same index without the variable: the approx sweep
    before = launch_counts()
    served_sweep = serve_and_record(app_sweep, "clustered-approx", texts[288:296], texts[296:],
                                    32, None)
    torch.cuda.synchronize()
    counts, tc_counts = launch_counts(), tc_launch_counts()  # the clustered path ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[clustered] launches on the clustered path: {counts}")
    check(counts["cell_gather_b1"] >= 8, "cell_gather_b1 was not launched by the library entry")
    check(counts["cell_gather"] >= 2, "cell_gather was not launched")
    check(tc_counts["cell_gather"] == counts["cell_gather"],
          f"cell_gather: {tc_counts['cell_gather']} of {counts['cell_gather']} launches took "
          "the tensor-core route")
    check(tc_counts["binmax_strided"] == counts["binmax_strided"],
          f"binmax_strided: {tc_counts['binmax_strided']} of {counts['binmax_strided']} "
          "launches of the approx sweep took the tensor-core route")
    n_probe_batches = len(served_probe["recorded"])
    check(probe_launches >= n_probe_batches > 0,
          f"cell_gather rose by {probe_launches} over {n_probe_batches} served batches")
    check(counts["cell_gather"] == before["cell_gather"]
          and counts["binmax_strided"] > before["binmax_strided"],
          "without SSKD_SERVE_CELL_PROBE the index was not served through the approx sweep")

    # --- every result against the same engine over the plain versions --------
    dev = dict(row_scales=b.device_scales, valid_n=b.ntotal)

    def plain_clustered(q, k=10):
        vals, idx = clustered_topk(q, b.device_vectors, b.device_centroids, k, b.nprobe,
                                   b._rows_per_cell, kernels=False, **dev)
        return vals.cpu().numpy(), b.map_positions(idx.cpu().numpy())

    def plain_approx(q, k=10):
        vals, idx = approx_topk(q, b.device_vectors, k, recall_target=b.recall_target,
                                kernels=False, **dev)
        return vals.cpu().numpy(), b.map_positions(idx.cpu().numpy())

    def as_searched(q: np.ndarray) -> torch.Tensor:
        """The queries as IndexBuilder.search hands them to its engine."""
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(q).cuda()

    lib_bad = 0
    for q, (vals, idx) in zip(batches, library):
        engine = plain_clustered if q.shape[0] <= CLUSTER_MAX_BATCH else plain_approx
        want_vals, want_idx = engine(as_searched(q))
        lib_bad += mismatched(idx, want_idx)
        check(np.isfinite(vals).all() and np.allclose(vals, want_vals, rtol=1e-6, atol=1e-7),
              f"library search B={q.shape[0]}: scores differ from the plain engine's")
        check(((idx >= 0) & (idx < N_ROWS)).all(), f"library search B={q.shape[0]}: bad ids")
    check(lib_bad == 0, f"library entry: {lib_bad} ids differ from the plain engines'")
    log(f"[clustered] library entry: B = 1 x 8, 16, 64 (cell probe) and 256 (approx sweep) "
        f"equal the plain engines: 0 mismatched ids of {sum(len(q) for q in batches) * 10}")
    probe_report = check_served(served_probe, app_probe.state,
                                lambda e: plain_clustered(e.float()), "clustered")
    check(max(probe_report["batch_rows"]) <= CLUSTER_MAX_BATCH, "a served batch exceeded 64")
    sweep_report = check_served(served_sweep, app_sweep.state,
                                lambda e: plain_approx(e.float()), "clustered-approx")
    del app_probe, app_sweep, served_probe, served_sweep

    # with every cell probed the clustered search is the exact search
    b.nprobe = N_CELLS
    full_vals, full_idx = b.search(rest[344:348], k=10)
    b.nprobe = NPROBE
    ev, ei = cosine_topk(as_searched(rest[344:348]), b.device_vectors, 10, **dev)
    check(same_topk(torch.from_numpy(full_vals), torch.from_numpy(full_idx),
                    ev.cpu(), torch.from_numpy(b.map_positions(ei.cpu().numpy())), 1e-6),
          "clustered search with nprobe = n_cells differs from the exact engine")

    # --- recall and the validation gates -------------------------------------
    _, exact_idx = cosine_topk(as_searched(q_val), b.device_vectors, 10, **dev)
    exact_idx = b.map_positions(exact_idx.cpu().numpy())
    got_idx = np.concatenate([b.search(q_val[i:i + CLUSTER_MAX_BATCH], k=10)[1]
                              for i in range(0, len(q_val), CLUSTER_MAX_BATCH)])
    recall = float(np.mean([len(set(exact_idx[i]) & set(got_idx[i])) / 10
                            for i in range(len(q_val))]))
    validate_clustered = b.validate(n_queries=1000)["recall@10"]
    b.index_type = "approx"  # the same rows, swept
    try:
        validate_approx = b.validate(n_queries=1000)["recall@10"]
        _, approx_idx = b.search(q_val, k=10)
    finally:
        b.index_type = "clustered"
    approx_recall = float(np.mean([len(set(exact_idx[i]) & set(approx_idx[i])) / 10
                                   for i in range(len(q_val))]))
    log(f"[clustered] recall@10 vs exact search over the same int8 rows, 1000 topical queries: "
        f"clustered nprobe {NPROBE} = {recall:.4f}, approx = {approx_recall:.4f}; validate(): "
        f"clustered {validate_clustered:.4f}, approx {validate_approx:.4f}")
    check(recall >= 0.90, f"clustered recall@10 {recall} < 0.90")
    check(validate_approx >= 0.97, f"approx validate() recall@10 {validate_approx} < 0.97")

    # --- ms per search, engine only, on this corpus --------------------------
    table, parts = {}, {}
    for B in (1, 16, 64):
        sets = [torch.from_numpy(q_val[i * B:(i + 1) * B]).cuda() for i in range(8)]
        engines = {
            "clustered": lambda q: clustered_topk(q, b.device_vectors, b.device_centroids, 10,
                                                  b.nprobe, b._rows_per_cell, **dev),
            "approx": lambda q: cosine_topk(q, b.device_vectors, 10, method="approx",
                                            recall_target=b.recall_target, **dev),
            "exact": lambda q: cosine_topk(q, b.device_vectors, 10, **dev),
        }
        table[f"B={B}"] = {name: time_ms(rotating(fn, [(q,) for q in sets]), 24, 4)
                           for name, fn in engines.items()}
        # the card's own time per search (all kernels): what is left of the eager
        # host pace above once the launches cost nothing; from the profiler where
        # the engine waits for the card (the clustered one checks its probe)
        for name, fn in engines.items():
            calls = rotating(fn, [(q,) for q in sets])
            table[f"B={B}"][name + "_device"] = (stream_device_ms(calls)
                                                 or kernel_device_ms(calls, ""))
        parts[f"B={B}"] = clustered_parts_ms(b, sets)
        parts[f"B={B}"]["distinct_cells"] = float(
            np.mean([torch.unique(probed_cells(b, q)).numel() for q in sets]))
        log(f"[clustered] engine ms B={B}: {json.dumps(table[f'B={B}'])}; clustered steps: "
            f"{json.dumps(parts[f'B={B}'])}")
    return {
        "rows": N_ROWS, "cells": [N_CELLS, CELL_ROWS], "nprobe": NPROBE,
        "build_seconds_host": build_s, "save_load_seconds": save_load_s,
        "library_mismatched_ids": lib_bad, "served_cell_probe": probe_report,
        "served_approx": sweep_report, "cell_gather_launches_served": probe_launches,
        "recall_at_10_clustered_vs_exact": recall, "recall_at_10_approx_vs_exact": approx_recall,
        "validate_clustered": validate_clustered, "validate_approx": validate_approx,
        "engine_ms": table, "clustered_steps_ms": parts,
        "peak_device_gib": peak_gib, "launches": counts, "tc_launches": tc_counts,
    }


# ---------------------------------------------------------------------------
# Phase 6: refined search and indexes of bf16 rows
# ---------------------------------------------------------------------------

REFINE_M = 40
REFINE_INDEXES = {  # (a) to (e), built from the topical corpus
    "a": dict(index_type="approx", dtype="int8", refine_m=REFINE_M),
    "b": dict(index_type="exact", dtype="int4", refine_m=REFINE_M),
    "c": dict(index_type="exact", dtype="bfloat16"),
    "d": dict(index_type="approx", dtype="bfloat16"),
    "e": dict(index_type="clustered", dtype="bfloat16", nprobe=NPROBE),
}
BF16_KERNELS = ("binmax", "bin_gather", "binmax_strided", "cell_gather", "cell_gather_b1")


def counters() -> dict:
    from sskd_tpu_torch.ops import bf16_launch_counts, launch_counts, tc_launch_counts

    return {"all": launch_counts(), "tc": tc_launch_counts(), "bf16": bf16_launch_counts()}


def counted_since(before: dict) -> dict:
    """The launches by kind and kernel since ``before`` (a ``counters()``)."""
    now = counters()
    return {kind: {k: v - before[kind][k] for k, v in now[kind].items()} for kind in now}


def tie_mismatches(got_v, got_i, want_v, want_i, tol: float) -> tuple[int, int]:
    """(ids that differ, those of them not a tie): an id in one result only
    is a tie when it scores within ``tol`` of that row's last score."""
    raw = untied = 0
    for r in range(got_i.shape[0]):
        a, b = got_i[r].tolist(), want_i[r].tolist()
        raw += sum(x != y for x, y in zip(a, b))
        for i in set(a) ^ set(b):
            v = got_v[r][a.index(i)] if i in a else want_v[r][b.index(i)]
            untied += abs(float(v) - float(want_v[r][-1])) > tol
    return raw, untied


def phase_refine(args, emb: np.ndarray, queries: np.ndarray) -> dict:
    """Indexes (a) to (e) of REFINE_INDEXES built from the topical corpus,
    saved and loaded; searched at the library entry and served; every result
    against the same engine over the plain versions; recall against exact
    f32 search over the original rows; the engines' ms per search."""
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import reset_launch_counts
    from sskd_tpu_torch.ops.topk import (
        approx_topk,
        cosine_topk,
        cosine_topk_core,
        refined_candidates,
        refined_candidates_core,
        refined_topk,
        refined_topk_core,
    )
    from sskd_tpu_torch.ops.topk_cluster import CLUSTER_MAX_BATCH, clustered_topk
    from sskd_tpu_torch.serve.app import create_app

    work = ROOT / "build" / "chip_smoke"
    ids = [f"doc-{i}" for i in range(N_ROWS)]
    q_val, rest = queries[:1000], queries[1000:]
    batches = [rest[i:i + 1] for i in range(8)] + [rest[8:24], rest[24:88], rest[88:344]]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the refine path starts here

    idx, build_s = {}, {}
    for name, kw in REFINE_INDEXES.items():
        t0 = time.perf_counter()
        built = IndexBuilder(384, device="cuda", **kw).build_from_arrays(emb, ids)
        build_s[name] = time.perf_counter() - t0
        built.save(work / f"refine_{name}")
        b = IndexBuilder(device="cuda").load(work / f"refine_{name}")
        check(b.ntotal == N_ROWS and b.dtype == kw["dtype"] and b.index_type == kw["index_type"]
              and b.refine_m == kw.get("refine_m", 0)
              and np.array_equal(b._vectors, built._vectors), f"({name}): loaded != built")
        del built
        b.ensure_device()
        idx[name] = b
    check((idx["e"]._centroids.shape[0], idx["e"]._rows_per_cell) == (N_CELLS, CELL_ROWS),
          "(e): not 977 cells x 1,024 rows")
    log(f"[refine] built, saved and loaded (a)-(e); build seconds {json.dumps(build_s)}")

    def as_searched(q: np.ndarray) -> torch.Tensor:
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(q.astype(np.float32)).cuda()

    def plain(name: str, q: torch.Tensor, storage: str = "device", builder=None):
        """The engine that index ``name`` is searched by over the plain
        versions, (vals, original ids) numpy: at the library entry
        (``idx[name]``), or as the app that loaded it as ``builder`` serves it
        (the refined engine for every index with refine rows)."""
        b = idx[name] if builder is None else builder
        dev = dict(row_scales=b.device_scales, valid_n=b.ntotal)
        kind = "approx" if builder is not None and b._refine is not None else b.index_type
        if b._refine is not None and kind == "approx":
            if storage == "host":
                _, cand = refined_candidates_core(q, b.device_vectors, REFINE_M, kernels=False,
                                                  **dev)
                return b._host_rescore(q.cpu().numpy(), cand.cpu().numpy(), 10)
            v, i = refined_topk_core(q, b.device_vectors, b.device_refine, 10,
                                     refine_m=b.refine_m, kernels=False, **dev)
        elif kind == "clustered" and q.shape[0] <= CLUSTER_MAX_BATCH:
            v, i = clustered_topk(q, b.device_vectors, b.device_centroids, 10, b.nprobe,
                                  b._rows_per_cell, kernels=False, **dev)
        elif kind in ("approx", "clustered"):
            v, i = approx_topk(q, b.device_vectors, 10, recall_target=b.recall_target,
                               kernels=False, **dev)
        else:
            v, i = cosine_topk_core(q, b.device_vectors, 10, **dev)
        return v.cpu().numpy(), b.map_positions(i.cpu().numpy())

    # --- the library entry: IndexBuilder.search at B = 1 (x 8), 16, 64, 256 ---
    library, routes = {}, {}
    exact_ids = {"a": True, "b": True}  # int8 / int4 sums: bit for bit with the plain versions
    for name, storage in (("a", "device"), ("a", "host"), ("b", "device"), ("c", "device"),
                          ("d", "device"), ("e", "device")):
        b = idx[name]
        b.refine_storage = storage
        before = counters()
        results = [b.search(q, k=10) for q in batches]
        torch.cuda.synchronize()
        tag = name + ("-host" if storage == "host" else "")
        routes[tag] = counted_since(before)
        raw = untied = 0
        for q, (vals, got) in zip(batches, results):
            want_v, want_i = plain(name, as_searched(q), storage)
            finite = np.isfinite(vals).all() and ((got >= 0) & (got < N_ROWS)).all()
            check(finite, f"library ({tag}) B={q.shape[0]}: bad scores or ids")
            check(np.allclose(vals, want_v, rtol=1e-5, atol=1e-6),
                  f"library ({tag}) B={q.shape[0]}: scores differ from the plain engine's")
            r, u = tie_mismatches(vals, got, want_v, want_i, 1e-5)
            raw, untied = raw + r, untied + u
        check(untied == 0 and (raw == 0 or not exact_ids.get(name)),
              f"library ({tag}): {raw} ids differ from the plain engine's, {untied} not ties")
        library[tag] = {"mismatched_ids": raw, "mismatched_ids_not_ties": untied,
                        "launches": routes[tag]["all"], "bf16_launches": routes[tag]["bf16"]}
        log(f"[refine] library ({tag}): {sum(len(q) for q in batches) * 10} ids, {raw} differ "
            f"from the plain engine's ({untied} not ties); launches {json.dumps(routes[tag])}")
    idx["a"].refine_storage = "device"
    # every launch on bf16 rows took a bf16 route; the refined paths their own routes
    for tag in ("c", "d", "e"):
        for k in BF16_KERNELS:
            check(routes[tag]["all"][k] == routes[tag]["bf16"][k],
                  f"({tag}): {routes[tag]['bf16'][k]} of {routes[tag]['all'][k]} {k} launches "
                  "took the bf16 route")
    check(routes["c"]["bf16"]["binmax"] > 0 and routes["c"]["bf16"]["bin_gather"] > 0,
          "(c) did not launch binmax and bin_gather")
    check(routes["c"]["tc"]["bin_gather"] == routes["c"]["all"]["bin_gather"],
          "(c): a bin_gather launch missed the bf16 tensor-core route")
    check(routes["d"]["bf16"]["binmax_strided"] > 0, "(d) did not launch binmax_strided")
    check(routes["e"]["bf16"]["cell_gather_b1"] >= 8 and routes["e"]["bf16"]["cell_gather"] >= 2
          and routes["e"]["bf16"]["binmax_strided"] >= 1, "(e) missed a cell kernel or the sweep")
    for tag in ("a", "a-host"):
        check(routes[tag]["tc"]["binmax_strided"] == routes[tag]["all"]["binmax_strided"] > 0,
              f"({tag}): the candidates did not come from the tensor-core strided pass")
    check(routes["b"]["tc"]["binmax"] == routes["b"]["all"]["binmax"] > 0
          and routes["b"]["tc"]["bin_gather"] == routes["b"]["all"]["bin_gather"] > 0
          and routes["b"]["bf16"]["binmax"] == 0,
          "(b): binmax and bin_gather did not take the tensor cores")

    # --- the served entry: (a) with the refine rows on the device and on the host, (b) once ---
    student_dir = work / "student"
    if not (student_dir / "sskd_config.json").exists():
        StudentModel("intfloat/e5-small-v2", device="cuda", compute_dtype=torch.bfloat16,
                     seed=args.seed).save(student_dir)
    texts = distinct_queries(32 + 256, args.seed + 13)
    served = {}
    for tag, name, storage, load_seed in (("refine-device", "a", "device", args.seed + 200),
                                          ("refine-host", "a", "host", args.seed + 300),
                                          ("refine-int4", "b", "device", None)):
        settings = Settings.from_dict({
            "index": {"refine_storage": storage},
            "service": {"micro_batch_window_ms": 5.0, "micro_batch_max_size": 64},
        })
        app = create_app(settings, student_model_path=str(student_dir), device="cuda",
                         preload_index_dir=str(work / f"refine_{name}"))
        before = counters()
        rec = serve_and_record(app, tag, texts[:32], texts[32:], 32, load_seed)
        torch.cuda.synchronize()
        launched = counted_since(before)
        sb = app.state.index_builder
        engine = "host_refined" if storage == "host" else "refined"
        check(sb.refine_storage == storage and app.state.fused_searcher._engine(16) == engine
              and (sb.device_refine is None) == (storage == "host"),
              f"[{tag}] the app did not serve the {engine} engine")
        if name == "a":
            check(launched["tc"]["binmax_strided"] == launched["all"]["binmax_strided"] > 0
                  and launched["all"]["binmax"] == 0,
                  f"[{tag}] the candidates did not come from the tensor-core strided pass")
        else:
            check(launched["tc"]["binmax"] == launched["all"]["binmax"] > 0
                  and launched["tc"]["bin_gather"] == launched["all"]["bin_gather"] > 0
                  and launched["all"]["binmax_strided"] == 0,
                  f"[{tag}] the candidates did not come from the int4 routes (binmax and "
                  "bin_gather on the tensor cores)")
        report = check_served(rec, app.state,
                              lambda e, sb=sb, st=storage: plain(name, e.float(), st, sb), tag)
        served[tag] = {**report, "launches": launched["all"], "tc_launches": launched["tc"]}
        del app, rec
    counts = counters()  # the refine path ends after recall and validate below

    # --- recall@10 against exact f32 search over the original rows -------------
    qv = as_searched(q_val)
    full = torch.from_numpy(emb).cuda()
    _, gt = cosine_topk_core(qv, full, 10)
    gt = gt.cpu().numpy()
    del full

    def recall(got: np.ndarray) -> float:
        return float(np.mean([len(set(gt[i]) & set(got[i])) / 10 for i in range(len(gt))]))

    def chunked(b):
        step = CLUSTER_MAX_BATCH if b.index_type == "clustered" else len(q_val)
        return np.concatenate([b.search(q_val[i:i + step], k=10)[1]
                               for i in range(0, len(q_val), step)])

    a, b4 = idx["a"], idx["b"]
    rec = {name: recall(chunked(idx[name])) for name in idx}
    rec["a_unrefined_int8_approx"] = recall(cosine_topk(
        qv, a.device_vectors, 10, row_scales=a.device_scales, method="approx",
        recall_target=a.recall_target)[1].cpu().numpy())
    rec["b_refined_served_path"] = recall(refined_topk(
        qv, b4.device_vectors, b4.device_refine, 10, refine_m=REFINE_M,
        row_scales=b4.device_scales)[1].cpu().numpy())
    for m in (100, 256):  # how many int4 candidates this corpus needs
        rec[f"b_refined_m{m}"] = recall(refined_topk(
            qv, b4.device_vectors, b4.device_refine, 10, refine_m=m,
            row_scales=b4.device_scales)[1].cpu().numpy())
    a.refine_storage = "host"
    rec["a_host"] = recall(chunked(a))
    a.refine_storage = "device"
    val = {name: b.validate(n_queries=1000)["recall@10"] for name, b in idx.items()}
    b4.index_type = "approx"  # (b)'s own rows through the refined engine that serves it
    try:
        val["b_as_approx_refined"] = b4.validate(n_queries=1000)["recall@10"]
    finally:
        b4.index_type = "exact"
    torch.cuda.synchronize()
    with_checks = counters()
    log(f"[refine] recall@10 vs exact f32 over the original rows, 1000 topical queries: "
        f"{json.dumps(rec)}; validate(): {json.dumps(val)}")
    check(rec["a"] >= rec["a_unrefined_int8_approx"] and rec["a"] >= 0.97
          and rec["a_host"] == rec["a"], f"(a) recall@10 {rec['a']}")
    check(rec["b_refined_served_path"] > rec["b"],
          f"(b): the rescore did not raise recall@10 ({rec['b_refined_served_path']} <= "
          f"{rec['b']})")
    check(rec["c"] >= 0.97, f"(c) recall@10 {rec['c']} < 0.97")
    check(rec["e"] >= 0.90, f"(e) recall@10 {rec['e']} < 0.90")
    for name in ("a", "c", "d"):
        check(val[name] >= 0.97, f"({name}) validate() {val[name]} < 0.97")
    check(val["e"] >= 0.90, f"(e) validate() {val['e']} < 0.90")
    check(val["b_as_approx_refined"] > val["b"],
          f"(b): validate() refined {val['b_as_approx_refined']} <= unrefined {val['b']}")

    # --- ms per search, engine only, eager and on the card ----------------------
    c, d, e = idx["c"], idx["d"], idx["e"]
    ad = dict(row_scales=a.device_scales, valid_n=N_ROWS)
    b4d = dict(row_scales=b4.device_scales, valid_n=N_ROWS)

    def host_refined(q):
        _, cand = refined_candidates(q, a.device_vectors, REFINE_M, **ad)
        return a._host_rescore(q.cpu().numpy(), cand.cpu().numpy(), 10)

    engines = {
        "refined_device": lambda q: refined_topk(q, a.device_vectors, a.device_refine, 10,
                                                 refine_m=REFINE_M, **ad),
        "refined_host": host_refined,
        "refined_host_candidates": lambda q: refined_candidates(q, a.device_vectors, REFINE_M,
                                                                **ad),
        "int8_approx_unrefined": lambda q: cosine_topk(q, a.device_vectors, 10, method="approx",
                                                       recall_target=a.recall_target, **ad),
        "bf16_exact": lambda q: cosine_topk(q, c.device_vectors, 10, valid_n=N_ROWS),
        "bf16_approx": lambda q: cosine_topk(q, d.device_vectors, 10, method="approx",
                                             recall_target=d.recall_target, valid_n=N_ROWS),
        "bf16_clustered": lambda q: clustered_topk(q, e.device_vectors, e.device_centroids, 10,
                                                   e.nprobe, e._rows_per_cell, valid_n=N_ROWS),
        # (b)'s int4 rows through the approx engine: binmax_strided over packed rows
        "int4_approx": lambda q: approx_topk(q, b4.device_vectors, 10, **b4d),
    }
    table, int4_approx = {}, {}
    for B in (1, 16, 64):
        sets = [(as_searched(q_val[i * B:(i + 1) * B]),) for i in range(8)]
        # the int4 approx engine on the tensor-core strided pass, against its plain pass
        before = counters()
        got_v, got_i = engines["int4_approx"](sets[0][0])
        launched = counted_since(before)
        want_v, want_i = approx_topk(sets[0][0], b4.device_vectors, 10, kernels=False, **b4d)
        check(launched["tc"]["binmax_strided"] == launched["all"]["binmax_strided"] == 1
              and torch.equal(got_i, want_i) and torch.equal(got_v, want_v),
              f"int4 approx B={B}: not the tensor-core strided pass, or not the plain result")
        int4_approx[f"B={B}"] = launched["all"]
        row = {}
        for ename, fn in engines.items():
            row[ename] = time_ms(rotating(fn, sets), 24, 4)
            if ename != "refined_host":  # it waits for the card: its device part is the next
                row[ename + "_device"] = stream_device_ms(rotating(fn, sets))
        table[f"B={B}"] = row
        log(f"[refine] engine ms B={B}: {json.dumps(row)}")
    return {
        "rows": N_ROWS, "refine_m": REFINE_M, "indexes": REFINE_INDEXES,
        "build_seconds": build_s, "library": library, "served": served,
        "recall_at_10_vs_f32": rec, "validate": val, "engine_ms": table,
        "int4_approx_launches": int4_approx,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts["all"], "tc_launches": counts["tc"], "bf16_launches": counts["bf16"],
        "launches_with_checks": with_checks["all"],
        "bf16_launches_with_checks": with_checks["bf16"],
    }


# ---------------------------------------------------------------------------
# Phase 7: the teacher (bge-reranker-large cross-encoder)
# ---------------------------------------------------------------------------

TEACHER_STEPS, TEACHER_BATCH, TEACHER_MAX_LEN = 16, 32, 64  # the CLI's train-teacher defaults
TEACHER_QUERIES = 80  # x 9 triples: 1 positive and 8 negatives each
SCORE_PAIRS = 1024
RERANK_TOP_K = 50
# the run at max_len 512: 4 steps of the CLI's batch, 16 queries x 9 triples,
# one step's gradients checked at a batch of 8
TEACHER_LONG_STEPS, TEACHER_LONG_LEN, TEACHER_LONG_QUERIES, TEACHER_GRAD_BATCH = 4, 512, 16, 8


def make_teacher_triples(n: int, seed: int, passage_words: tuple = (20, 60)) -> list:
    """Seeded synthetic (query, passage, label) triples, 1 positive to 8
    negatives a query: a 4-8 word query, a positive that repeats its words
    among others, negatives of other words; ``passage_words`` words a
    passage (20-60 by default)."""
    lo, hi = passage_words
    rng = np.random.default_rng(seed)
    triples = []
    for _ in range(n):
        query = list(rng.choice(WORDS, rng.integers(4, 9)))
        pos = query * 2 + list(rng.choice(WORDS, rng.integers(lo - 10, hi - 10)))
        rng.shuffle(pos)
        triples.append((" ".join(query), " ".join(pos), 1.0))
        for _ in range(8):
            neg = [w for w in rng.choice(WORDS, rng.integers(lo, hi + 1)) if w not in query]
            triples.append((" ".join(query), " ".join(neg), 0.0))
    order = rng.permutation(len(triples))
    return [triples[i] for i in order]


def make_score_pairs(n: int, seed: int) -> list:
    """(query, passage) pairs whose passages run 30, 180, 330 and 480 words
    in turns of 32 pairs, so that score's chunks of 32 fall in the buckets
    of 64, 256 and 512 tokens (the last two both 512)."""
    rng = np.random.default_rng(seed)
    return [(" ".join(rng.choice(WORDS, 6)),
             " ".join(rng.choice(WORDS, 30 + 150 * ((i // 32) % 4)))) for i in range(n)]


def teacher_grads(trainer, ids, mask, types, labels, plain: bool) -> torch.Tensor:
    """Every parameter's gradient (flat, f32) of one teacher train step's
    loss at a fixed dropout seed, without the update: through the dropattn
    kernels, or (``plain``) through their plain versions in f32."""
    from sskd_tpu_torch.kd.teacher_train import sigmoid_binary_cross_entropy
    from sskd_tpu_torch.models import bert

    module = trainer.teacher.module
    saved = bert.dropout_attention
    if plain:
        bert.dropout_attention = (
            lambda q, k, v, bias, p, seed: PlainDropoutAttention.apply(q, k, v, bias, p, seed,
                                                                        torch.float32))
    try:
        module.train()
        module.zero_grad(set_to_none=True)
        logits = module(ids, mask, types, dropout_seed=13)
        sigmoid_binary_cross_entropy(logits, labels).mean().backward()
        return torch.cat([p.grad.detach().flatten() for p in module.parameters()])
    finally:
        bert.dropout_attention = saved
        module.zero_grad(set_to_none=True)
        module.eval()


def train_teacher_long(args, teacher) -> dict:
    """TeacherTrainer.train at max_len 512 (the CLI's --max-len for a
    teacher that scores at 512, as bge-reranker-large does and rerank
    buckets reach) with the CLI's batch 32 and rate, TEACHER_LONG_STEPS
    steps, on seeded triples whose passages fill 512 tokens: every loss
    finite, 24 dropattn_fwd and 24 dropattn_bwd launches a step at d = 64,
    every backward on the streaming route; ms per step, samples/s and peak
    memory; then one step's gradients through the kernels within 1e-3 of the
    plain pair's at a batch of 8 (where the plain pair's [8, 16, 512, 512]
    f32 fits)."""
    from sskd_tpu_torch.kd.teacher_train import TeacherTrainer
    from sskd_tpu_torch.ops import (
        head_dim_launch_counts,
        launch_counts,
        reset_launch_counts,
        tc_launch_counts,
    )
    from sskd_tpu_torch.ops import attention as ta

    cfg = teacher.config
    d = cfg.hidden_size // cfg.num_heads
    route = ta.dropattn_bwd_route(torch.float32, d, TEACHER_LONG_LEN)
    check(route == "tc_stream", f"teacher at max_len 512: backward route {route}")
    triples = make_teacher_triples(TEACHER_LONG_QUERIES, args.seed + 1, passage_words=(300, 480))
    trainer = TeacherTrainer(teacher, learning_rate=1e-3, seed=args.seed + 1)
    inner = trainer._train_step
    starts, events = [], []

    def timed_step(ids, mask, types, labels, step):
        if step == 1:  # the peak counts steps 2 on
            torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        starts.append(time.perf_counter())
        start.record()
        loss = inner(ids, mask, types, labels, step)
        end.record()
        events.append((start, end))
        return loss

    trainer._train_step = timed_step
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.train(triples, steps=TEACHER_LONG_STEPS, batch_size=TEACHER_BATCH,
                           max_len=TEACHER_LONG_LEN)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts, tc_counts, by_d = launch_counts(), tc_launch_counts(), head_dim_launch_counts()
    stream = ta.dropattn_bwd.stream_launches
    trainer._train_step = inner
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[teacher] max_len 512: {TEACHER_LONG_STEPS} steps in {train_s:.1f} s; launches "
        f"{counts}, tensor-core {tc_counts}, by head dim {by_d}, streaming {stream}")
    losses = result["losses"]
    check(len(losses) == TEACHER_LONG_STEPS and all(math.isfinite(x) for x in losses),
          f"teacher max_len 512 losses {losses}")
    want = TEACHER_LONG_STEPS * cfg.num_layers
    for name in ("dropattn_fwd", "dropattn_bwd"):
        check(counts[name] == want and by_d[name] == {d: want} and tc_counts[name] == want,
              f"teacher max_len 512: {name} {counts[name]} launches {by_d[name]}, "
              f"{tc_counts[name]} on the tensor cores; want {want} at d = {d}, all on them")
    check(stream == want, f"teacher max_len 512: {stream} of {want} backward launches streamed")
    event_ms = [a.elapsed_time(b) for a, b in events]
    cadence_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    ms_step = float(np.median(event_ms[1:]))
    batch, labels = trainer._tokenize(triples[:TEACHER_GRAD_BATCH], TEACHER_LONG_LEN)
    ids, mask, types = (torch.from_numpy(batch[k]).cuda().long()
                        for k in ("input_ids", "attention_mask", "token_type_ids"))
    check(ids.shape == (TEACHER_GRAD_BATCH, TEACHER_LONG_LEN), f"grad batch {tuple(ids.shape)}")
    lab = torch.from_numpy(labels).cuda()
    g_kernel = teacher_grads(trainer, ids, mask, types, lab, plain=False)
    g_plain = teacher_grads(trainer, ids, mask, types, lab, plain=True)
    g_norm = g_plain.norm().item()
    grad_rel = (g_kernel - g_plain).norm().item() / g_norm
    del g_kernel, g_plain, trainer
    torch.cuda.empty_cache()
    record = {
        "steps": TEACHER_LONG_STEPS, "batch": TEACHER_BATCH, "max_len": TEACHER_LONG_LEN,
        "triples": len(triples), "train_seconds": train_s, "losses": losses,
        "step_event_ms": event_ms, "step_cadence_ms": cadence_ms, "event_ms_median": ms_step,
        "samples_per_s": TEACHER_BATCH / (ms_step / 1e3), "peak_device_gib": peak_gib,
        "launches": counts, "head_dim_launches": by_d, "tc_launches": tc_counts,
        "stream_launches": stream, "route": route,
        "grad_check": {"batch": TEACHER_GRAD_BATCH, "grad_norm": g_norm,
                       "kernel_vs_plain_rel": grad_rel},
    }
    log(f"[teacher] max_len 512: {json.dumps(record)}")
    check(math.isfinite(grad_rel) and g_norm > 0 and grad_rel <= 1e-3,
          f"teacher max_len 512: gradients through the kernels vs the plain pair: {grad_rel} "
          "> 1e-3")
    return record


def phase_teacher(args) -> dict:
    """The teacher path at full bge-reranker-large width (24 layers, hidden
    1024, 16 heads of 64, FFN 4096, vocab 250,002, roberta positions; seeded
    random weights, f32 compute, dropout 0.1): TeacherTrainer.train with the
    CLI's defaults, save and reload, TeacherModel.score of 1,024 pairs in
    buckets up to 512, and /search with rerank=true served by create_app over
    the serve phase's index and student."""
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.kd.teacher_train import TeacherTrainer
    from sskd_tpu_torch.models.teacher import TeacherModel
    from sskd_tpu_torch.ops import (
        head_dim_launch_counts,
        launch_counts,
        reset_launch_counts,
        tc_launch_counts,
    )
    from sskd_tpu_torch.ops import attention as ta
    from sskd_tpu_torch.serve.app import create_app

    work = ROOT / "build" / "chip_smoke"
    record: dict = {}
    t0 = time.perf_counter()
    teacher = TeacherModel("BAAI/bge-reranker-large", device="cuda", seed=args.seed)
    record["init_seconds"] = time.perf_counter() - t0
    cfg = teacher.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.vocab_size,
           cfg.max_position_embeddings, cfg.pad_token_id, cfg.position_style, cfg.layer_norm_eps,
           cfg.type_vocab_size) == (24, 1024, 16, 4096, 250002, 514, 1, "roberta", 1e-5, 1),
          f"not bge-reranker-large width: {cfg}")
    check(cfg.compute_dtype == torch.float32 and cfg.hidden_dropout == 0.1
          and cfg.attention_dropout == 0.1, "not f32 compute with dropout 0.1")
    n_params = sum(p.numel() for p in teacher.module.parameters())
    log(f"[teacher] bge-reranker-large width, {n_params:,} parameters, seeded in "
        f"{record['init_seconds']:.1f} s")

    # ---- training ------------------------------------------------------
    triples = make_teacher_triples(TEACHER_QUERIES, args.seed)
    trainer = TeacherTrainer(teacher, learning_rate=1e-3, seed=args.seed)
    inner = trainer._train_step
    starts, events, snaps = [], [], []

    def timed_step(ids, mask, types, labels, step):
        # each step between CUDA events, its host start time; step 1 between
        # parameter snapshots (its rate is 0: the parameters must not move)
        if step == 0:
            snaps.append([p.detach().clone() for p in teacher.module.parameters()])
        elif step == 1:
            torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        starts.append(time.perf_counter())
        start.record()
        loss = inner(ids, mask, types, labels, step)
        end.record()
        events.append((start, end))
        if step == 0:
            snaps.append(all(torch.equal(a, b.detach())
                             for a, b in zip(snaps.pop(), teacher.module.parameters())))
        return loss

    trainer._train_step = timed_step
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.train(triples, steps=TEACHER_STEPS, batch_size=TEACHER_BATCH,
                           max_len=TEACHER_MAX_LEN)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts, tc_counts, by_d = launch_counts(), tc_launch_counts(), head_dim_launch_counts()
    trainer._train_step = inner
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[teacher] trained {TEACHER_STEPS} steps in {train_s:.1f} s; launches {counts}, "
        f"tensor-core {tc_counts}, by head dim {by_d}")
    losses = result["losses"]
    check(len(losses) == TEACHER_STEPS and all(math.isfinite(x) for x in losses),
          f"teacher losses {losses}")
    check(snaps == [True], "teacher step 1 changed the parameters (its learning rate is 0)")
    # one forward and one backward a layer a step: no remat
    want = TEACHER_STEPS * cfg.num_layers
    routes = {"dropattn_fwd": ta.dropattn_fwd_route(torch.float32, 64, TEACHER_MAX_LEN),
              "dropattn_bwd": ta.dropattn_bwd_route(torch.float32, 64, TEACHER_MAX_LEN)}
    check(routes == {"dropattn_fwd": "tc", "dropattn_bwd": "tc"}, f"teacher routes {routes}")
    for name, route in routes.items():
        check(counts[name] == want and by_d[name] == {64: want},
              f"{name}: {counts[name]} launches {by_d[name]}, want {want} at d = 64")
        # every launch at d = 64 (above): so all of them on the route when tc counts them all
        check(tc_counts[name] == (want if route == "tc" else 0),
              f"{name}: {tc_counts[name]} tensor-core launches on the {route} route")
    event_ms = [a.elapsed_time(b) for a, b in events]
    cadence_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    ms_step = float(np.median(cadence_ms[2:]))
    record["train"] = {
        "steps": TEACHER_STEPS, "batch": TEACHER_BATCH, "max_len": TEACHER_MAX_LEN,
        "triples": len(triples), "train_seconds": train_s, "losses": losses,
        "step_cadence_ms": cadence_ms, "step_event_ms": event_ms,
        "ms_per_step_median": ms_step,
        "event_ms_median": float(np.median(event_ms[2:])),
        "samples_per_s": TEACHER_BATCH / (ms_step / 1e3), "peak_device_gib": peak_gib,
        "heldout_pair_accuracy": result["heldout_pair_accuracy"],
        "step1_unchanged": True, "launches": counts, "head_dim_launches": by_d,
        "tc_launches": tc_counts, "routes": routes,
    }

    # one step's gradients through the kernels against the plain pair (f32:
    # summation order only, so far below 1e-3 of the gradient's norm)
    batch, labels = trainer._tokenize(triples[:TEACHER_BATCH], TEACHER_MAX_LEN)
    ids, mask, types = (torch.from_numpy(batch[k]).cuda().long()
                        for k in ("input_ids", "attention_mask", "token_type_ids"))
    lab = torch.from_numpy(labels).cuda()
    g_kernel = teacher_grads(trainer, ids, mask, types, lab, plain=False)
    g_plain = teacher_grads(trainer, ids, mask, types, lab, plain=True)
    g_norm = g_plain.norm().item()
    grad_rel = (g_kernel - g_plain).norm().item() / g_norm
    del g_kernel, g_plain
    record["train"]["grad_check"] = {"grad_norm": g_norm, "kernel_vs_plain_rel": grad_rel}
    log(f"[teacher] {json.dumps(record['train'])}")
    check(math.isfinite(grad_rel) and g_norm > 0 and grad_rel <= 1e-3,
          f"teacher gradients through the kernels vs the plain pair: {grad_rel} > 1e-3")
    del trainer
    torch.cuda.empty_cache()
    # ---- training at max_len 512, the backward streaming -----------------
    record["train_512"] = train_teacher_long(args, teacher)

    # ---- save, reload, score -------------------------------------------
    t0 = time.perf_counter()
    teacher_dir = teacher.save(work / "teacher")
    trained = {k: v.detach().cpu() for k, v in teacher.module.state_dict().items()}
    del teacher
    torch.cuda.empty_cache()
    scorer = TeacherModel(str(teacher_dir), device="cuda")
    check(all(torch.equal(v.cpu(), trained[k]) for k, v in scorer.module.state_dict().items()),
          "the reloaded teacher differs from the trained one")
    record["save_load_seconds"] = time.perf_counter() - t0
    del trained
    pairs = make_score_pairs(SCORE_PAIRS, args.seed)
    lengths = [scorer.tokenize_pairs(pairs[i:i + TEACHER_BATCH])["input_ids"].shape[1]
               for i in range(0, SCORE_PAIRS, TEACHER_BATCH)]
    n512 = lengths.count(512)
    check(n512 > 0, f"no chunk reached L = 512: {lengths}")
    scorer.score(pairs[:TEACHER_BATCH])  # first use of the card's cuBLAS handles
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    scores = scorer.score(pairs, batch_size=TEACHER_BATCH)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    counts, by_d, tc_counts = launch_counts(), head_dim_launch_counts(), tc_launch_counts()
    n_flash = cfg.num_layers * n512
    check(counts["flash_attn_fwd"] == n_flash and by_d["flash_attn_fwd"] == {64: n_flash}
          and tc_counts["flash_attn_fwd"] == n_flash,
          f"flash_attn_fwd: {counts['flash_attn_fwd']} launches {by_d['flash_attn_fwd']}, "
          f"{tc_counts['flash_attn_fwd']} on the tensor cores, want {cfg.num_layers} for each "
          f"of {n512} chunks at L = 512, at d = 64, all on the tensor-core route")
    real_flash = ta.flash_attention
    ta.flash_attention = lambda q, k, v, m=None: ta.flash_attention_plain(q, k, v, m)
    try:
        plain_scores = scorer.score(pairs, batch_size=TEACHER_BATCH)
    finally:
        ta.flash_attention = real_flash
    diff = np.abs(np.asarray(scores) - np.asarray(plain_scores))
    # f32 throughout: the kernel and its plain version differ by summation
    # order, which 24 layers carry to the logits far below 1e-4 (1 + |s|)
    score_slack = float(np.max(diff / (1e-4 * (1.0 + np.abs(plain_scores)))))
    check(all(math.isfinite(x) for x in scores) and score_slack <= 1.0,
          f"teacher scores through the kernels vs the plain versions: {score_slack} of 1e-4")
    # where one chunk's forward at L = 512 spends the card's time (outside
    # the counted run): CUDA events, and device time by kernel from a
    # profiled window that holds every flash launch of its calls
    chunk = scorer.tokenize_pairs(pairs[lengths.index(512) * TEACHER_BATCH:][:TEACHER_BATCH])
    chunk_ms = time_ms(lambda: scorer.forward_batch(chunk), 5, 1)
    by_kernel, windows = checked_device_times(lambda: scorer.forward_batch(chunk), "flash_fwd",
                                              cfg.num_layers)
    record["score"] = {
        "pairs": SCORE_PAIRS, "batch_size": TEACHER_BATCH, "chunk_lengths": lengths,
        "chunks_at_512": n512, "seconds": score_s, "pairs_per_s": SCORE_PAIRS / score_s,
        "max_abs_diff_vs_plain": float(diff.max()), "diff_over_bound": score_slack,
        "launches": counts, "head_dim_launches": by_d, "tc_launches": tc_counts,
        "chunk512_ms": chunk_ms,
        # None when no window of ten held the chunk's 24 flash launches
        "chunk512_device_ms": None if by_kernel is None else sum(t for _, t in by_kernel),
        "chunk512_top_kernels_ms": None if by_kernel is None else by_kernel[:8],
        "chunk512_windows": windows,
    }
    log(f"[teacher] score: {json.dumps(record['score'])}")

    # ---- rerank served --------------------------------------------------
    settings = Settings.from_dict({
        "index": {"search_method": "exact"},
        "service": {"micro_batch_window_ms": 5.0, "micro_batch_max_size": 64},
        "search": {"rerank_enabled": True, "rerank_top_k": RERANK_TOP_K,
                   "rerank_timeout_ms": 60000.0},
        "teacher": {"model_name": str(teacher_dir), "batch_size": TEACHER_BATCH},
    })
    app = create_app(settings, student_model_path=str(work / "student"), device="cuda",
                     preload_index_dir=str(work / "index"))
    reset_launch_counts()
    rerank_ms = []
    queries = [" ".join(np.random.default_rng(args.seed + 100 + i).choice(WORDS, 6))
               for i in range(6)]
    with live_server(app, "teacher") as (port, startup_s):
        state = app.state
        check(state.teacher is not None, "the app started with reranking off")
        served_score = state.teacher.score

        def timed_score(pairs_, bs):
            t = time.perf_counter()
            out = served_score(pairs_, bs)
            rerank_ms.append((time.perf_counter() - t) * 1e3)
            return out

        state.teacher.score = timed_score
        sequential = []
        for q in queries:
            status, plain, _ = post(port, "/search", {"query": q, "k": RERANK_TOP_K})
            check(status == 200 and plain["reranked"] is False, f"/search {q!r}: {status}")
            status, body, ms = post(port, "/search", {"query": q, "k": 10, "rerank": True,
                                                      "rerank_top_k": RERANK_TOP_K})
            check(status == 200 and body["reranked"] is True,
                  f"/search rerank {q!r}: HTTP {status}, reranked {body.get('reranked')}")
            sequential.append((q, plain, body, ms))
        loads = [run_load(port, n, c, args.seed + 200 + c, rerank=True)
                 for n, c in ((8, 1), (32, 8))]
        for load in loads:
            log(f"[teacher] rerank closed loop: {json.dumps(load)}")
            check(load["failed"] == 0, f"{load['failed']} of {load['requests']} rerank requests "
                  f"failed ({load['not_reranked']} not reranked)")
        state.teacher.score = served_score
    torch.cuda.synchronize()
    counts, by_d, tc_counts = launch_counts(), head_dim_launch_counts(), tc_launch_counts()
    check(by_d["flash_attn_fwd"].get(64, 0) > 0
          and tc_counts["flash_attn_fwd"] == counts["flash_attn_fwd"] == by_d["flash_attn_fwd"][64],
          f"rerank: flash_attn_fwd {counts['flash_attn_fwd']} launches {by_d['flash_attn_fwd']}, "
          f"{tc_counts['flash_attn_fwd']} on the tensor cores; want all at d = 64 on them")
    # each reranked response in the order of TeacherModel.score on its pairs
    worst = 0.0
    for q, plain, body, _ in sequential:
        want = scorer.score([(q, r["text"] or r["doc_id"]) for r in plain["results"]],
                            batch_size=TEACHER_BATCH)
        order = sorted(range(len(want)), key=lambda i: -want[i])[:10]
        got_scores = [r["score"] for r in body["results"]]
        worst = max(worst, max(abs(a - want[i]) for a, i in zip(got_scores, order)))
        for r, i in zip(body["results"], order):
            check(r["doc_id"] == plain["results"][i]["doc_id"]
                  or abs(r["score"] - want[i]) <= 1e-5,
                  f"rerank {q!r}: {r['doc_id']} where the teacher ranks "
                  f"{plain['results'][i]['doc_id']}")
    check(worst <= 1e-5, f"served rerank scores differ from TeacherModel.score by {worst}")
    lat = sorted(ms for *_, ms in sequential)
    record["rerank"] = {
        "startup_seconds": startup_s, "top_k": RERANK_TOP_K, "sequential_ms": lat,
        "sequential_p50_ms": float(np.percentile(lat, 50)), "load": loads,
        "rerank_ms": rerank_ms, "rerank_p50_ms": float(np.percentile(rerank_ms, 50)),
        "max_score_diff_vs_score": worst, "launches": counts, "head_dim_launches": by_d,
        "tc_launches": tc_counts,
    }
    log(f"[teacher] rerank: {json.dumps(record['rerank'])}")
    del scorer, app
    torch.cuda.empty_cache()
    record["teacher_launches"] = {
        "dropattn_fwd.d64": record["train"]["head_dim_launches"]["dropattn_fwd"][64],
        "dropattn_bwd.d64": record["train"]["head_dim_launches"]["dropattn_bwd"][64],
        "flash_attn_fwd.d64": record["score"]["head_dim_launches"]["flash_attn_fwd"][64],
    }
    return record


# ---------------------------------------------------------------------------
# Phase 7b: distributed (data-parallel KD at world size 1, the teacher's TP)
# ---------------------------------------------------------------------------

DIST_BATCH, DIST_DOCS, DIST_QUERY_LEN, DIST_DOC_LEN = 32, 8, 64, 192  # the train phase's
DIST_STEPS_P0, DIST_STEPS_P1 = 3, 2  # at dropout 0 (in-batch negatives), then at 0.1
TP_PAIRS = slice(32, 96)  # make_score_pairs' chunks at the 256 and 512 buckets


def timed_train(trainer, samples, out_dir: Path) -> tuple[dict, list]:
    """``trainer.train`` over one epoch of ``samples``, each step between
    CUDA events; returns the result and the steps' milliseconds."""
    inner, events = trainer._train_step, []

    def step(*a):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        aux = inner(*a)
        end.record()
        events.append((start, end))
        return aux

    trainer._train_step = step
    try:
        result = trainer.train(samples, output_dir=out_dir, query_len=DIST_QUERY_LEN,
                               doc_len=DIST_DOC_LEN)
    finally:
        trainer._train_step = inner
    torch.cuda.synchronize()
    return result, [a.elapsed_time(b) for a, b in events]


# the kernels of the index axis over the group: the exact engine's pair and
# the clustered engine's cell gather at B >= 16
INDEX_AXIS_KERNELS = ("binmax", "bin_gather", "cell_gather")
SHARD_RANK_TIMEOUT_S = 240  # both ranks of (f), start to exit


def gap(got: tuple, want: tuple) -> tuple[int, float]:
    """(mismatched ids, largest score gap) of two ``(scores, ids)`` results."""
    return mismatched(got[1], want[1]), float(np.abs(got[0] - want[0]).max())


def index_axis_world1(reference: dict) -> dict:
    """(e) The index axis over the NCCL group of one rank: the serve phase's
    1M x 384 int8 exact index and the clustered phase's int8 index, each
    sharded over two entries on ``cuda:0`` of a mesh over the group (the
    candidates meet in the group's all-gather), searched at
    SHARDED_BATCHES. The exact ids are the single-device engine's; the
    clustered index's two shards probe ``nprobe`` cells each, so its ids
    are held against the same two shards on a mesh of this process alone,
    and over one group entry against the single-device engine. Every
    binmax, bin_gather and cell_gather launch on its tensor-core route;
    ms per batch beside the one-process mesh's."""
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.parallel.mesh import create_mesh

    work = ROOT / "build" / "chip_smoke"
    cuda0 = torch.device("cuda", 0)
    q = reference["queries"]
    builders = {"exact": IndexBuilder(device="cuda").load(work / "index"),
                "clustered": IndexBuilder(device="cuda").load(work / "clustered_index")}
    group = {n: create_mesh(1, n, devices=[cuda0] * n, ranks=[0] * n) for n in (1, 2)}
    local = create_mesh(1, 2, devices=[cuda0] * 2)
    indexes = {(name, mesh_name): ShardedIndex.from_builder(b, mesh)
               for name, b in builders.items()
               for mesh_name, mesh in (("group", group[2]), ("local", local))}
    indexes[("clustered", "group1")] = ShardedIndex.from_builder(builders["clustered"], group[1])
    for (name, mesh_name), idx in indexes.items():
        check(idx.over_group == mesh_name.startswith("group") and idx.stop - idx.first
              == idx.n_shards, f"{name} over {mesh_name}: shards {idx.first}..{idx.stop}")

    torch.cuda.synchronize()
    reset_launch_counts()
    got = {key: {B: indexes[key].search(q[:B], k=10) for B in SHARDED_BATCHES}
           for key in (("exact", "group"), ("clustered", "group"), ("clustered", "group1"))}
    torch.cuda.synchronize()
    counts, tc_counts = launch_counts(), tc_launch_counts()
    for kernel in INDEX_AXIS_KERNELS:
        check(counts[kernel] > 0 and tc_counts[kernel] == counts[kernel],
              f"(e) {kernel}: {counts[kernel]} launches, {tc_counts[kernel]} on the tensor cores")
    local_got = {name: {B: indexes[(name, "local")].search(q[:B], k=10) for B in SHARDED_BATCHES}
                 for name in builders}
    checks = {}
    for label, ours, theirs in (
            ("exact vs single-device", got[("exact", "group")], reference["exact"]),
            ("exact vs one-process mesh", got[("exact", "group")], local_got["exact"]),
            ("clustered vs one-process mesh", got[("clustered", "group")], local_got["clustered"]),
            ("clustered one entry vs single-device", got[("clustered", "group1")],
             reference["clustered"])):
        gaps = [gap(ours[B], theirs[B]) for B in SHARDED_BATCHES]
        checks[label] = {"mismatched_ids": sum(g[0] for g in gaps),
                         "max_score_gap": max(g[1] for g in gaps)}
        check(checks[label]["mismatched_ids"] == 0 and checks[label]["max_score_gap"] <= 1e-6,
              f"(e) {label}: {checks[label]}")
    # two shards probe 2 x nprobe cells: not gated against one device's nprobe
    info = [gap(got[("clustered", "group")][B], reference["clustered"][B])[0]
            for B in SHARDED_BATCHES]
    ms = {f"B={B}": {mesh_name: time_ms(lambda: indexes[("exact", mesh_name)].search(
        q[:B], k=10), iters=10) for mesh_name in ("group", "local")} for B in SHARDED_BATCHES}
    log(f"[distributed] (e) index axis over the NCCL group of 1, two entries on cuda:0: "
        f"{json.dumps(checks)}; clustered two shards vs one device {info} ids differ; "
        f"exact ms per batch {json.dumps(ms)}")
    del indexes, builders
    torch.cuda.empty_cache()
    return {"checks": checks, "clustered_two_shards_vs_single_mismatches": info,
            "exact_ms_per_batch": ms,
            "launches": {k: counts[k] for k in (*INDEX_AXIS_KERNELS, "cell_gather_b1")},
            "tc_launches": {k: tc_counts[k] for k in INDEX_AXIS_KERNELS}}


def index_axis_two_ranks(reference: dict) -> dict:
    """(f) Two ranks on the one card: NCCL refuses two ranks on one device,
    so they join a gloo group and each places its index-axis entry on
    ``cuda:0`` (``create_mesh(1, 2)`` over the group). Each is this script
    run with ``--shard-rank`` (:func:`shard_rank_worker`) and loads its half
    of the sharded phase's sskd-sharded-1 index; its index memory, its ids
    at SHARDED_BATCHES against the single-device engine's, its binmax and
    bin_gather launches (all on the tensor cores) and its ms per batch,
    beside the one-process two-shard index over the same files."""
    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.parallel.mesh import create_mesh

    work = ROOT / "build" / "chip_smoke"
    ranks_dir = work / "two_ranks"
    ranks_dir.mkdir(parents=True, exist_ok=True)
    q = reference["queries"]
    np.save(ranks_dir / "queries.npy", q)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    one = ShardedIndex(create_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2)).load(
        work / "sharded_index")
    torch.cuda.synchronize()
    one_bytes = torch.cuda.memory_allocated() - base
    for B in SHARDED_BATCHES:
        n_bad, score_gap = gap(one.search(q[:B], k=10), reference["exact"][B])
        check(n_bad == 0 and score_gap <= 1e-6, f"(f) one process B={B}: {n_bad} ids differ")
    one_ms = {f"B={B}": time_ms(lambda: one.search(q[:B], k=10), iters=10)
              for B in SHARDED_BATCHES}
    del one
    torch.cuda.empty_cache()

    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank",
                               f"{r},{port},{ranks_dir}"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=SHARD_RANK_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"(f) the two ranks did not finish within {SHARD_RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    check([p.returncode for p in procs] == [0, 0],
          "(f) a rank failed:\n" + "\n".join(log_[-3000:] for log_ in logs))
    ranks = [json.loads((ranks_dir / f"rank_{r}.json").read_text()) for r in (0, 1)]
    for r, got in enumerate(ranks):
        share = got["index_bytes"] / one_bytes
        check(got["shards"] == [r, r + 1, 2] and got["over_group"],
              f"(f) rank {r} holds shards {got['shards']}")
        check(0.45 <= share <= 0.55, f"(f) rank {r} holds {share:.3f} of the index's memory")
        for B in SHARDED_BATCHES:
            n_bad, score_gap = gap((np.asarray(got["scores"][str(B)], np.float32),
                                    np.asarray(got["ids"][str(B)], np.int32)),
                                   reference["exact"][B])
            check(n_bad == 0 and score_gap <= 1e-6,
                  f"(f) rank {r} B={B}: {n_bad} ids differ, scores by {score_gap}")
        for kernel in ("binmax", "bin_gather"):
            check(got["launches"][kernel] > 0
                  and got["tc_launches"][kernel] == got["launches"][kernel],
                  f"(f) rank {r} {kernel}: {got['launches'][kernel]} launches, "
                  f"{got['tc_launches'][kernel]} on the tensor cores")
        got["index_share"] = share
        del got["ids"], got["scores"]
    log(f"[distributed] (f) two gloo ranks on cuda:0: each holds "
        f"{[round(r['index_share'], 4) for r in ranks]} of the one-process index's "
        f"{one_bytes} bytes, the single-device ids at B in {SHARDED_BATCHES}; ms per batch "
        f"{[r['ms_per_batch'] for r in ranks]}, one process {json.dumps(one_ms)}; "
        f"{wall:.1f} s with the ranks' start")
    return {"one_process_index_bytes": one_bytes, "one_process_ms_per_batch": one_ms,
            "ranks": ranks, "seconds": wall}


def shard_rank_worker(rank: int, port: int, work: Path) -> int:
    """One rank of (f): joins the gloo group of two, loads its half of the
    sskd-sharded-1 index onto ``cuda:0``, searches the queries at
    SHARDED_BATCHES in step with the other rank, and writes what it saw to
    ``work/rank_R.json``."""
    import torch.distributed as dist

    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.parallel.distributed import initialize_distributed
    from sskd_tpu_torch.parallel.mesh import create_mesh

    t0 = time.perf_counter()
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout_s=120)
    join_s = time.perf_counter() - t0
    mesh = create_mesh(1, 2, device="cuda")
    cuda0 = torch.device("cuda", 0)
    check(mesh.ranks == ((0, 1),) and mesh.devices == ((cuda0, cuda0),),
          f"rank {rank}: mesh {mesh}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = ShardedIndex(mesh).load(work.parent / "sharded_index")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    index_bytes = torch.cuda.memory_allocated() - base
    q = np.load(work / "queries.npy")
    reset_launch_counts()
    got = {B: index.search(q[:B], k=10) for B in SHARDED_BATCHES}
    torch.cuda.synchronize()
    counts, tc_counts = launch_counts(), tc_launch_counts()
    ms = {f"B={B}": time_ms(lambda: index.search(q[:B], k=10), iters=10)
          for B in SHARDED_BATCHES}
    out = {"rank": rank, "shards": [index.first, index.stop, index.n_shards],
           "over_group": index.over_group, "join_seconds": join_s, "load_seconds": load_s,
           "index_bytes": index_bytes, "rows_per_shard": index.rows_per_shard,
           "ids": {str(B): v[1].tolist() for B, v in got.items()},
           "scores": {str(B): v[0].tolist() for B, v in got.items()},
           "launches": {k: counts[k] for k in ("binmax", "bin_gather")},
           "tc_launches": {k: tc_counts[k] for k in ("binmax", "bin_gather")},
           "ms_per_batch": ms}
    (work / f"rank_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_distributed(args, reference: dict) -> dict:
    """(a) ``initialize_distributed`` from the SSKD_* variables at world size
    1 on NCCL, an all-reduce and an all-gather of CUDA tensors; (b)
    ``KDTrainer(mesh=create_mesh(data_parallel=1))`` at full e5-small-v2
    width with the train phase's settings against the single-device trainer
    from the same init (3 steps at dropout 0 with in-batch negatives, then 2
    at dropout 0.1 with the dropattn launches the code implies, on the
    tensor cores); (c) ``set_mesh`` encode against ``encode``; (d) the
    teacher phase's saved teacher, ``shard_tensor_parallel`` over a one-device
    mesh and over two slices of the one card, against its unsharded scores;
    (e) and (f) the index axis over the group (:func:`index_axis_world1`,
    :func:`index_axis_two_ranks`) against ``reference``, the sharded phase's
    queries and single-device results."""
    import tempfile

    import torch.distributed as dist

    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.kd.dataset import KDDataset
    from sskd_tpu_torch.kd.train import KDTrainer
    from sskd_tpu_torch.models.bert import BertConfig
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.models.teacher import TeacherModel
    from sskd_tpu_torch.ops import (
        head_dim_launch_counts,
        launch_counts,
        reset_launch_counts,
        tc_launch_counts,
    )
    from sskd_tpu_torch.parallel.distributed import (
        all_gather_rows,
        all_reduce_sum_,
        barrier,
        broadcast_object,
        initialize_distributed,
    )
    from sskd_tpu_torch.parallel.mesh import create_mesh
    from sskd_tpu_torch.parallel.tp import tp_sharding_summary

    record: dict = {}
    env = {"SSKD_COORDINATOR": f"127.0.0.1:{free_port()}", "SSKD_NUM_PROCESSES": "1",
           "SSKD_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        # ---- (a) the group and its collectives --------------------------
        t0 = time.perf_counter()
        check(initialize_distributed(timeout_s=120), "initialize_distributed did not join")
        join_s = time.perf_counter() - t0
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"group {dist.get_backend()} of {dist.get_world_size()}, want nccl of 1")
        x = torch.randn(4, 384, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
        summed = x.clone()
        all_reduce_sum_([summed])
        gathered = all_gather_rows(x)
        leaf = x.clone().requires_grad_()
        all_gather_rows(leaf).sum().backward()
        check(torch.equal(summed, x) and torch.equal(gathered, x)
              and torch.equal(leaf.grad, torch.ones_like(x)),
              "world-1 all-reduce / all-gather changed their input")
        barrier()  # the waits for rank 0's work alone, in their gloo group
        check(broadcast_object({"rank": 0}) == {"rank": 0}, "broadcast_object changed its input")
        record["collectives"] = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                                 "join_seconds": join_s}

        # ---- (b) data-parallel KD against the single-device trainer ------
        def settings(epochs=1):
            s = Settings.from_dict({"training": {
                "epochs": epochs, "batch_size": DIST_BATCH, "learning_rate": 2e-5,
                "weight_decay": 0.01, "warmup_ratio": 0.1, "max_grad_norm": 1.0,
                "num_docs_per_query": DIST_DOCS, "remat": True, "remat_policy": "full",
                "resume": False, "seed": args.seed}})
            s.loss.in_batch_negatives = True
            return s

        def student(p: float):
            cfg = BertConfig.e5_small_v2(hidden_dropout=p, attention_dropout=p)
            return StudentModel("intfloat/e5-small-v2", device="cuda", config=cfg,
                                compute_dtype=torch.bfloat16, seed=args.seed)

        mesh = create_mesh(data_parallel=1)
        towers = 2 * 12
        runs = {}
        with tempfile.TemporaryDirectory(prefix="sskd_dist_") as tmp:
            for p, n_steps, names in ((0.0, DIST_STEPS_P0, ("single", "data_parallel", "again")),
                                      (0.1, DIST_STEPS_P1, ("single", "data_parallel"))):
                samples = make_kd_samples(DIST_BATCH * n_steps, DIST_DOCS, args.seed + 11)
                for name in names:
                    st = student(p)
                    trainer = KDTrainer(st, settings(),
                                        mesh=mesh if name == "data_parallel" else None)
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    result, step_ms = timed_train(trainer, samples, Path(tmp) / f"{name}_{p}")
                    runs[(p, name)] = {
                        "student": st, "trainer": trainer, "step_ms": step_ms,
                        "steps": result["global_step"],
                        "losses": [h["train_loss"] for h in result["history"]],
                        "launches": launch_counts(), "tc_launches": tc_launch_counts()}

        def param_gap(a, b) -> tuple[bool, float]:
            """Whether two students' parameters are equal bit for bit, and
            their largest |a - b| / (1 + |b|)."""
            theirs, same, worst = dict(b.module.named_parameters()), True, 0.0
            for name, q in a.module.named_parameters():
                want = theirs[name].detach()
                same &= torch.equal(q.detach(), want)
                worst = max(worst, ((q.detach() - want).abs() / (1 + want.abs())).max().item())
            return same, worst

        p0s, p0d = runs[(0.0, "single")], runs[(0.0, "data_parallel")]
        bitwise, worst = param_gap(p0d["student"], p0s["student"])
        # the single-device trainer run twice: whether the step itself repeats its bits
        again_bitwise, again_worst = param_gap(runs[(0.0, "again")]["student"], p0s["student"])
        log(f"[distributed] dropout 0: data-parallel vs single-device parameters bitwise "
            f"{bitwise}, max |dp| / (1 + |p|) {worst:.3g}; single-device run twice: bitwise "
            f"{again_bitwise}, {again_worst:.3g}")
        check(p0d["steps"] == p0s["steps"] == DIST_STEPS_P0, f"steps {p0d['steps']}")
        # world 1 makes the same calls on the same values and the collectives
        # copy: equal bits, else within 1e-6 (1 + |p|), as far as the
        # single-device step repeats itself
        check(bitwise or worst <= 1e-6, f"data-parallel parameters off by {worst} (1 + |p|)")
        p1 = runs[(0.1, "data_parallel")]
        counts, tc_counts = p1["launches"], p1["tc_launches"]
        check(all(math.isfinite(x) for x in p1["losses"]) and p1["steps"] == DIST_STEPS_P1,
              f"dropout 0.1 run: {p1['steps']} steps, losses {p1['losses']}")
        check(counts["dropattn_fwd"] == DIST_STEPS_P1 * 2 * towers
              and counts["dropattn_bwd"] == DIST_STEPS_P1 * towers,
              f"dropattn launches {counts['dropattn_fwd']} / {counts['dropattn_bwd']}, want "
              f"{DIST_STEPS_P1 * 2 * towers} / {DIST_STEPS_P1 * towers}")
        check(tc_counts["dropattn_fwd"] == counts["dropattn_fwd"]
              and tc_counts["dropattn_bwd"] == counts["dropattn_bwd"],
              f"dropattn tensor-core launches {tc_counts}")
        check(p0d["launches"]["dropattn_fwd"] == 0, "dropout 0 launched dropattn_fwd")

        # ms a step at dropout 0.1 of both trainers on one packed batch, in
        # turns (single, data-parallel, data-parallel, single), 4 steps a turn
        packed = next(KDDataset(make_kd_samples(DIST_BATCH, DIST_DOCS, args.seed + 13),
                                p1["student"].tokenizer, num_docs=DIST_DOCS,
                                query_len=DIST_QUERY_LEN, doc_len=DIST_DOC_LEN)
                      .batches(DIST_BATCH, shuffle=False))
        turns = {"single": [], "data_parallel": []}
        for name in ("single", "data_parallel", "data_parallel", "single"):
            trainer = runs[(0.1, name)]["trainer"]
            trainer._prepare_module()
            for i in range(4):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                trainer._train_step(packed, 0.5, 100 + i)
                end.record()
                torch.cuda.synchronize()
                turns[name].append(start.elapsed_time(end))
            trainer.student.module.eval()
        ms = {name: float(np.median(t)) for name, t in turns.items()}
        # the collectives a data-parallel step adds, alone at this step's
        # sizes: the three loss counts, the docs' embeddings and validity,
        # the gradients (one all-reduce of the optimizer's flat buffer, of
        # which every .grad is a view), the four loss terms
        flat = runs[(0.1, "data_parallel")]["trainer"]._opt._flat
        rows = DIST_BATCH * DIST_DOCS
        docs, valid = torch.zeros(rows, 384, device="cuda"), torch.ones(rows, device="cuda")
        scalars = [torch.ones((), device="cuda") for _ in range(3)]
        terms = torch.zeros(4, device="cuda")

        def step_collectives():
            all_reduce_sum_(scalars)
            all_gather_rows(docs)
            all_gather_rows(valid)
            all_reduce_sum_([flat])
            all_reduce_sum_([terms])

        collectives_ms = time_ms(step_collectives, 10)
        record["train"] = {
            "batch": DIST_BATCH, "docs": DIST_DOCS, "doc_len": DIST_DOC_LEN,
            "params_bitwise": bitwise, "max_param_diff_rel": worst,
            "single_twice_bitwise": again_bitwise, "single_twice_max_diff_rel": again_worst,
            "losses": {f"{n}_p{p}": r["losses"] for (p, n), r in runs.items()},
            "train_step_ms": {f"{n}_p{p}": r["step_ms"] for (p, n), r in runs.items()},
            "turn_step_ms": turns, "ms_per_step": ms,
            "step_ms_difference": ms["data_parallel"] - ms["single"],
            "collectives_ms_per_step": collectives_ms,
            "grad_bytes": flat.numel() * flat.element_size(),
            "launches": counts, "tc_launches": tc_counts,
        }
        log(f"[distributed] train: {json.dumps(ms)} ms a step (median of 8 in turns); the "
            f"step's collectives alone {collectives_ms:.3f} ms")

        # ---- (c) data-parallel encode --------------------------------------
        enc = p0d["student"]
        texts = [s.query for s in make_kd_samples(100, 2, args.seed + 12)]
        enc.set_mesh(mesh)
        got = enc.encode(texts, batch_size=64)
        enc.set_mesh(None)
        want = enc.encode(texts, batch_size=64)
        check(got.shape == (100, 384) and np.array_equal(got, want),
              f"set_mesh encode differs from encode by {np.abs(got - want).max()}")
        record["encode"] = {"texts": len(texts), "equal": True}
        del runs, p0s, p0d, p1, enc, trainer, flat

        # ---- (e) the index axis over the group: two entries on cuda:0 ------
        record["index_axis"] = index_axis_world1(reference)
    finally:
        for key in env:
            os.environ.pop(key, None)
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- (f) two gloo ranks, each holding its half of the index on cuda:0 ------
    record["two_ranks"] = index_axis_two_ranks(reference)

    # ---- (d) the teacher's tensor parallelism ---------------------------------
    teacher = TeacherModel(str(ROOT / "build" / "chip_smoke" / "teacher"), device="cuda")
    pairs = make_score_pairs(SCORE_PAIRS, args.seed)[TP_PAIRS]
    lengths = [teacher.tokenize_pairs(pairs[i:i + TEACHER_BATCH])["input_ids"].shape[1]
               for i in range(0, len(pairs), TEACHER_BATCH)]
    n512 = lengths.count(512)
    check(n512 > 0, f"no chunk reached L = 512: {lengths}")
    chunk = teacher.tokenize_pairs(pairs[lengths.index(512) * TEACHER_BATCH:][:TEACHER_BATCH])
    want = np.asarray(teacher.score(pairs, batch_size=TEACHER_BATCH))
    tp_record = {"pairs": len(pairs), "chunk_lengths": lengths,
                 "unsharded_chunk512_ms": time_ms(lambda: teacher.forward_batch(chunk), 5, 1)}
    unsharded = teacher.module
    cfg = teacher.config
    for case, devices in (("one_device", [torch.device("cuda", 0)]),
                          ("two_slices", [torch.device("cuda", 0)] * 2)):
        ip = len(devices)
        teacher.module, teacher.device = unsharded, torch.device("cuda")
        teacher.shard_tensor_parallel(create_mesh(data_parallel=1, index_parallel=ip,
                                                  devices=devices))
        shard = teacher.module.encoder.layers[0].shards[0]
        check(shard.attention.num_heads == cfg.num_heads // ip
              and shard.intermediate.weight.shape[0] == cfg.intermediate_size // ip,
              f"{case}: a shard holds {shard.attention.num_heads} heads, "
              f"{shard.intermediate.weight.shape[0]} FFN columns")
        torch.cuda.synchronize()
        reset_launch_counts()
        got = np.asarray(teacher.score(pairs, batch_size=TEACHER_BATCH))
        torch.cuda.synchronize()
        counts, by_d, tc_counts = launch_counts(), head_dim_launch_counts(), tc_launch_counts()
        n_flash = cfg.num_layers * ip * n512
        check(counts["flash_attn_fwd"] == n_flash and by_d["flash_attn_fwd"] == {64: n_flash}
              and tc_counts["flash_attn_fwd"] == n_flash,
              f"{case}: flash_attn_fwd {counts['flash_attn_fwd']} launches "
              f"{by_d['flash_attn_fwd']}, {tc_counts['flash_attn_fwd']} on the tensor cores, "
              f"want {cfg.num_layers * ip} a chunk at L = 512, d = 64")
        slack = float(np.max(np.abs(got - want) / (1e-4 * (1.0 + np.abs(want)))))
        check(np.isfinite(got).all() and slack <= 1.0,
              f"{case}: tensor-parallel scores off the unsharded ones by {slack} of 1e-4")
        tp_record[case] = {
            "devices": [str(d) for d in devices], "heads_per_shard": shard.attention.num_heads,
            "summary": tp_sharding_summary(teacher.module),
            "max_abs_diff": float(np.abs(got - want).max()), "diff_over_bound": slack,
            "launches": counts["flash_attn_fwd"], "tc_launches": tc_counts["flash_attn_fwd"],
            "flash_launches_per_512_chunk": counts["flash_attn_fwd"] // n512,
            "chunk512_ms": time_ms(lambda: teacher.forward_batch(chunk), 5, 1),
        }
        log(f"[distributed] tp {case}: {json.dumps(tp_record[case])}")
    check(tp_record["two_slices"]["summary"] == tp_record["one_device"]["summary"],
          "the placement summary depends on the slice count")
    record["tp"] = tp_record
    record["launches"] = {
        "dropattn_fwd": record["train"]["launches"]["dropattn_fwd"],
        "dropattn_bwd": record["train"]["launches"]["dropattn_bwd"],
        "flash_attn_fwd.d64": tp_record["two_slices"]["launches"],
    }
    # the index axis over the group: (e) at world 1, (f) each of the two ranks
    record["index_axis_launches"] = {
        name: {"world1": record["index_axis"]["launches"][name],
               **{f"rank{r['rank']}": r["launches"][name] for r in record["two_ranks"]["ranks"]
                  if name in r["launches"]}}
        for name in INDEX_AXIS_KERNELS}
    del teacher, unsharded
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# Phase 8: evaluation
# ---------------------------------------------------------------------------

DEMO = ROOT / "artifacts" / "demo"
DEMO_TEST = DEMO / "data" / "raw" / "demo" / "test.jsonl"
EVAL_KS = (1, 5, 10, 20)
EVAL_QUERIES = 1000  # 12-word spans of distinct passages, each its passage's query
CHUNKED_PASSAGES = 1024  # the chunked corpus and the rerank corpus
RERANK_QUERIES, RERANK_K = 64, 10
QUALITY_QUERIES, QUALITY_DOCS = 64, 8


def max_gap(got: dict, want: dict) -> float:
    check(set(got) == set(want), f"metric keys differ: {sorted(set(got) ^ set(want))}")
    return max(abs(got[k] - want[k]) for k in want)


def eval_checkpoints() -> dict:
    """(a) The JAX package's demo checkpoints, each read from its
    params.msgpack: load_eval_inputs(test.jsonl, 600) (90 queries, 871
    passages), evaluate_retrieval of both students and
    evaluate_retrieval_teacher on the card. These models are short-text and
    tiny (hidden 128 with 4 heads, 64 with 4): their L stays under
    FLASH_MIN_L and 871 rows under the exact engine's kernel gate, so this
    part launches no kernel."""
    from sskd_tpu_torch.cli.pipeline import load_eval_inputs
    from sskd_tpu_torch.kd.eval import KDEvaluator
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.models.teacher import TeacherModel
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    q_map, corpus, qrels = load_eval_inputs(DEMO_TEST, 600)
    check((len(q_map), len(corpus)) == (90, 871),
          f"demo split: {len(q_map)} queries, {len(corpus)} passages, want 90 and 871")
    card = KDEvaluator(device="cuda")
    reset_launch_counts()
    rows = {}
    for name, sub in (("kd_student", "run_kd/best_model"), ("vanilla", "vanilla")):
        check((DEMO / sub / "params.msgpack").exists() and not (DEMO / sub / "weights.pt").exists(),
              f"{sub}: not a JAX checkpoint directory")
        rows[name] = card.evaluate_retrieval(StudentModel(str(DEMO / sub), device="cuda"),
                                             q_map, corpus, qrels)
    teacher = TeacherModel(str(DEMO / "teacher"), device="cuda")
    rows["teacher"] = card.evaluate_retrieval_teacher(teacher, q_map, corpus, qrels)
    torch.cuda.synchronize()
    launches = launch_counts()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kd_cpu = KDEvaluator(device="cpu").evaluate_retrieval(
        StudentModel(str(DEMO / "run_kd/best_model"), device="cpu"), q_map, corpus, qrels)
    cpu_s = time.perf_counter() - t0
    recorded = {name: json.loads((DEMO / f"{name}_metrics.json").read_text())
                for name in ("vanilla", "teacher", "kd_student")}
    gaps = {
        "vanilla_vs_json": max_gap(rows["vanilla"], recorded["vanilla"]),
        "teacher_vs_json": max_gap(rows["teacher"], recorded["teacher"]),
        "kd_student_vs_cpu": max_gap(rows["kd_student"], kd_cpu),
        # the checkpoint changed after the JSON was written: recorded, not held
        "kd_student_vs_json": max_gap(rows["kd_student"], recorded["kd_student"]),
    }
    teacher_ndcg = rows["teacher"]["ndcg@10"]
    gate = {"teacher_ndcg@10": teacher_ndcg, "threshold": 0.95 * teacher_ndcg,
            "kd_passes": bool(rows["kd_student"]["ndcg@10"] >= 0.95 * teacher_ndcg)}
    # the report and the gate line as `semantic-kd compare` prints them
    report = KDEvaluator.generate_report(rows, title="Model comparison")
    report += (f"\nAcceptance gate (KD >= {0.95:.0%} of teacher nDCG@10 = "
               f"{gate['threshold']:.4f}): **{'PASSED' if gate['kd_passes'] else 'FAILED'}**\n")
    for line in report.splitlines():
        log(f"[eval] {line}")
    out = {"rows": rows, "kd_student_cpu": kd_cpu, "gaps": gaps, "gate": gate,
           "launches": launches, "card_seconds": card_s, "cpu_seconds": cpu_s}
    log(f"[eval] checkpoints: {json.dumps({k: out[k] for k in ('gaps', 'gate', 'launches')})}")
    for key in ("vanilla_vs_json", "teacher_vs_json", "kd_student_vs_cpu"):
        check(gaps[key] <= 1e-3, f"eval {key}: a metric {gaps[key]} away (gate 1e-3)")
    check(not gate["kd_passes"], "the gate PASSED on the demo checkpoints, where the JAX "
          "package's evaluator finds it FAILED")
    check(sum(launches.values()) == 0, f"the tiny models launched kernels: {launches}")
    return out


def native_tokenize(tok, texts: list[str], cap: int) -> dict:
    """(c) The native WordPiece core: attached, the same ids as pure Python
    on every text, and the ms to tokenize them each way on the card's host."""
    check(tok._native_core() is not None,
          "the native WordPiece core is not attached (native/wordpiece.cc did not build)")
    t0 = time.perf_counter()
    core_ids = [tok.tokenize(t) for t in texts]
    core_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch_ids = tok.ids_batch(texts, cap)
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py_ids = [tok._tokenize_python(t)[0] for t in texts]
    py_ms = (time.perf_counter() - t0) * 1e3
    check(core_ids == py_ids, "the native core's ids differ from pure Python's")
    check(all(b.tolist() == p[:cap] for b, p in zip(batch_ids, py_ids)),
          "the core's batch ids differ from pure Python's")
    out = {"texts": len(texts), "tokens": sum(len(i) for i in py_ids),
           "core_ms": core_ms, "core_batch_ms": batch_ms, "python_ms": py_ms,
           "host_cpus": os.cpu_count()}
    log(f"[eval] native tokenizer: {json.dumps(out)}")
    return out


def eval_kernel_cases(q: torch.Tensor, d: torch.Tensor, seed: int, build: dict) -> dict:
    """The kernels the full-width evaluation launches, at its shapes, against
    their plain versions (outside its counted run): binmax and bin_gather
    over its f32 rows (B = 1,000 queries x 8,192 passages, k = 20) and
    flash_attn_fwd in f32 at [256, 12, 512, 32] (its encode, on the tensor
    cores: flash_fwd_tc_tf32_kernel<32>, bitwise repeatable), each beside
    the library call or yardstick and its bound (flash: also the three TF32
    passes, the CUDA cores' FMA bound, the exp floor and ptxas's registers
    and spills)."""
    from sskd_tpu_torch.ops import attention as ta
    from sskd_tpu_torch.ops import topk_kernels as tk

    B, n, dim = q.shape[0], d.shape[0], d.shape[1]
    out = {}
    check(tk.binmax_route(d.dtype, dim * 4) == "cuda_core", "f32 binmax route")
    got = tk.binmax(q, d, None, n)
    want = tk.binmax_plain(q, d, None, n)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= 1e-5, f"binmax f32 B={B}: max abs err {err} > 1e-5")
    n_bins = got.shape[0]
    b_ms, b_by = bound_ms(n * dim * 4 + B * dim * 4 + n_bins * B * 4, 2.0 * B * n * dim, "f32")
    out["binmax.f32"] = {
        "kernel": "binmax", "dtype": "f32", "B": B, "N": n, "D": dim, "route": "cuda_core",
        "max_abs_err": err, "ms": time_ms(lambda: tk.binmax(q, d, None, n), 20),
        "kernel_device_ms": kernel_device_ms(lambda: tk.binmax(q, d, None, n),
                                             "binmax_f32_kernel", 8),
        "plain_ms": time_ms(lambda: tk.binmax_plain(q, d, None, n), 5, 1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: (d @ q.T)[: (n // 128) * 128].view(-1, 128, B).amax(1),
                              10),
    }
    kb = min(20, n_bins)
    _, bins = tk.topk_stable(want.T, kb)
    bins = bins.to(torch.int32).contiguous()
    check(tk.bin_gather_route(d.dtype, dim * 4) == "f32_tc", "f32 bin_gather route")
    g_got = routed(tk.bin_gather, "f32_tc", lambda: tk.bin_gather(q, None, d, None, bins, n))
    g_want = tk.bin_gather_plain(q, None, d, None, bins, n)
    torch.cuda.synchronize()
    g_err = (g_got - g_want).abs().max().item()
    check(g_err <= 1e-5, f"bin_gather f32 B={B}: max abs err {g_err} > 1e-5")
    # the kernel this route took before (bin_gather_kernel), on the same inputs
    parent = bin_gather_cuda_cores(q, None, d, None, bins, n)
    torch.cuda.synchronize()
    p_err = (parent - g_want).abs().max().item()
    check(p_err <= 1e-5, f"bin_gather_kernel f32 B={B}: max abs err {p_err} > 1e-5")
    cand = B * kb * 128
    distinct = torch.unique(bins).numel()
    # bytes: each distinct bin's rows once; operations: the products at the CUDA
    # cores' FMA rate (bin_gather_kernel's bound) and as three TF32 passes (this route's)
    gb_ms, gb_by = bound_ms(distinct * 128 * dim * 4 + cand * 4 + bins.numel() * 4
                            + B * dim * 4, 3 * 2.0 * cand * dim, "tf32")
    pick = (bins.long()[:, :, None] * 128
            + torch.arange(128, device="cuda")).view(-1).clamp(max=n - 1)
    g_call = lambda: tk.bin_gather(q, None, d, None, bins, n)
    out["bin_gather.f32"] = {
        "kernel": "bin_gather", "dtype": "f32", "B": B, "kb": kb, "distinct_bins": distinct,
        "route": "f32_tc", "max_abs_err": g_err,
        "ms": time_ms(g_call, 20),
        "kernel_device_ms": kernel_device_ms(g_call, "bin_gather_f32_tc_kernel", 8),
        # the wrapper's whole device time: the stable sort by bin and the kernel
        "call_device_ms": stream_device_ms(g_call, 20),
        "plain_ms": time_ms(lambda: tk.bin_gather_plain(q, None, d, None, bins, n), 2, 1),
        "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": None,
        "fma_bound_ms": 2.0 * cand * dim / PEAK_OPS["f32"] * 1e3,
        "cuda_core_kernel_max_abs_err": p_err,
        "cuda_core_kernel_device_ms": kernel_device_ms(
            lambda: bin_gather_cuda_cores(q, None, d, None, bins, n), "bin_gather_kernel", 8),
        "yardstick_index_select_bmm_ms": time_ms(lambda: torch.bmm(
            d.index_select(0, pick).view(B, kb * 128, dim), q[:, :, None]), 10),
        **f32_gather_layouts(q, d, bins, n),
    }
    del g_got, g_want, got, want, parent

    gen = torch.Generator(device="cuda").manual_seed(seed)
    Bf, h, L, hd = 256, 12, 512, 32
    check(ta.flash_route(torch.float32, hd) == "tc", "f32 flash route at d = 32")
    qf, kf, vf = (torch.randn(Bf, h, L, hd, device="cuda", generator=gen) for _ in range(3))
    lens = torch.randint(L // 8, L + 1, (Bf,), device="cuda", generator=gen)
    lens[0] = L
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    before = ta.flash_attention.tc_launches
    got = ta.flash_attention(qf, kf, vf, mask)
    f_err = (got - ta.flash_attention_plain(qf, kf, vf, mask)).abs().max().item()
    check(ta.flash_attention.tc_launches == before + 1, "f32 flash d=32: not the tensor cores")
    check(f_err <= 1e-5, f"flash_attn_fwd f32 d=32: max abs err {f_err} > 1e-5")
    check(torch.equal(got, ta.flash_attention(qf, kf, vf, mask)), "f32 flash d=32: launches differ")
    del got
    keep = mask[:, None, None, :].bool()
    n_bytes = 4 * Bf * h * L * hd * 4 + Bf * L * 4
    ops = 4.0 * Bf * h * L * L * hd
    fb_ms, fb_by = bound_ms(n_bytes, ops, "tf32")
    out["flash_attn_fwd.f32"] = {
        "kernel": "flash_attn_fwd", "dtype": "f32", "shape": [Bf, h, L, hd],
        "route": "tc", "max_abs_err": f_err, "bitwise_repeatable": True,
        "ms": time_ms(lambda: ta.flash_attention(qf, kf, vf, mask), 10),
        "kernel_device_ms": kernel_device_ms(lambda: ta.flash_attention(qf, kf, vf, mask),
                                             "flash_fwd_tc_tf32_kernel", 8),
        "plain_ms": time_ms(lambda: ta.flash_attention_plain(qf, kf, vf, mask), 3, 1),
        "bound_ms": fb_ms, "bound_by": fb_by,
        "byte_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        # three TF32 passes at TF32's peak, and the same products on the CUDA
        # cores' FMA (the bound of flash_fwd_kernel<float, 32>, which this
        # route replaced)
        "three_pass_ms": 3 * ops / PEAK_OPS["tf32"] * 1e3,
        "cuda_core_bound_ms": ops / PEAK_OPS["f32"] * 1e3,
        "exp_floor_ms": Bf * h * L * L / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=keep), 10),
        "ptxas": ptxas_of(build, "flash_attn", "tc_tf32_kernelILi32E"),
    }
    for entry in out.values():
        log(f"[eval] kernel {json.dumps(entry)}")
    return out


def ranking_gap(metrics: dict, want_rank: list, qids: list, qrels: dict, ks,
                tie_rows: int) -> float:
    """How far the evaluator's ``metrics`` are from those of ``want_rank`` (per
    query, doc ids in rank order), less each tie row's share: a row whose
    ids differ only at ties can move a mean metric by at most 1 / len(qids)."""
    from sskd_tpu_torch.utils.metrics import compute_retrieval_metrics

    results = {q: [float(qrels.get(q, {}).get(doc, 0.0)) for doc in rank]
               for q, rank in zip(qids, want_rank)}
    total = {q: sum(1 for v in qrels.get(q, {}).values() if v > 0) for q in qids}
    gap = max_gap(metrics, compute_retrieval_metrics(results, total, ks=ks))
    return max(0.0, gap - tie_rows / len(qids))


def eval_full_width(args, build: dict) -> dict:
    """(b) The evaluator at e5-small-v2's full width (12 layers, hidden 384,
    12 heads, seeded weights, f32 compute as the JAX StudentModel defaults
    to) over the 8,192 passages of the serve phase (L = 512: flash in f32 at
    d = 32, on the tensor cores) and 1,000 seeded 12-word spans of distinct
    passages, each relevant to its passage alone; evaluate_retrieval (ranked
    by binmax and bin_gather in f32, B = 1,000 in one launch each),
    evaluate_retrieval_chunked over 1,024 passages in TextChunker(512, 80)
    windows, evaluate_retrieval_reranked with the teacher phase's saved
    full-width teacher (64 queries, rerank_k 10; its flash on
    flash_fwd_tc_tf32_kernel<64>), evaluate_ranking_quality on 64 queries x
    8 passages; and (c) the native WordPiece core on the 8,192 passages."""
    from scipy.stats import kendalltau

    from sskd_tpu_torch.kd import eval as kd_eval
    from sskd_tpu_torch.kd.eval import KDEvaluator, block_rows_for
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.models.teacher import TeacherModel
    from sskd_tpu_torch.ops import (
        head_dim_launch_counts,
        launch_counts,
        reset_launch_counts,
        tc_launch_counts,
    )
    from sskd_tpu_torch.ops import attention as ta
    from sskd_tpu_torch.ops import topk_kernels as tk
    from sskd_tpu_torch.ops.topk import cosine_topk_core
    from sskd_tpu_torch.utils.chunk import TextChunker, maxsim_aggregate_topk

    record: dict = {}
    parts_s: dict = {}
    student = StudentModel("intfloat/e5-small-v2", device="cuda", seed=args.seed)
    cfg = student.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.vocab_size)
          == (12, 384, 12, 30522) and cfg.compute_dtype == torch.float32,
          f"not e5-small-v2 width in f32: {cfg}")
    passages = make_passages(N_DOCS, args.seed)
    rng = np.random.default_rng(args.seed + 300)
    picks = rng.choice(N_DOCS, EVAL_QUERIES, replace=False)
    queries, qrels = {}, {}
    for i, p in enumerate(picks):
        words = passages[p].split()
        s = int(rng.integers(0, len(words) - 12))
        queries[f"q{i}"] = " ".join(words[s : s + 12])
        qrels[f"q{i}"] = {f"p{p}": 1.0}
    corpus = {f"p{j}": text for j, text in enumerate(passages)}
    qids, doc_ids = list(queries), list(corpus)

    # (c) the native core, on the passages as the encoder sees them
    t0 = time.perf_counter()
    record["native"] = native_tokenize(
        student.tokenizer, [student.passage_prefix + p for p in passages],
        student.max_seq_length)
    parts_s["native"] = time.perf_counter() - t0

    # the evaluator's rankings and its encode times, recorded as it runs
    real_topk = kd_eval.cosine_topk
    ranked: list = []
    timed: dict = {}

    def recording_topk(q, d, k, **kw):
        out = real_topk(q, d, k, **kw)
        ranked.append((q, d, k, kw, out))
        return out

    def timing(fn, name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            timed[name] = timed.get(name, 0.0) + time.perf_counter() - t
            return out
        return call

    kd_eval.cosine_topk = recording_topk
    student.encode_documents = timing(student.encode_documents, "encode_documents_s")
    student.encode_queries = timing(student.encode_queries, "encode_queries_s")
    ev = KDEvaluator(k_values=EVAL_KS, device="cuda")
    try:
        # ---- evaluate_retrieval: the main path of the phase --------------
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = ev.evaluate_retrieval(student, queries, corpus, qrels)
        torch.cuda.synchronize()
        parts_s["evaluate_retrieval"] = time.perf_counter() - t0
        encode_s = dict(timed)  # the evaluator's own encodes, before the checks' encode
        counts, tc_counts, by_d = launch_counts(), tc_launch_counts(), head_dim_launch_counts()
        log(f"[eval] full width: {json.dumps(metrics)}; launches {counts}, tensor-core "
            f"{tc_counts}, by head dim {by_d}; {json.dumps(timed)}")
        n_flash = cfg.num_layers * -(-N_DOCS // ev.batch_size)  # queries stay under 512
        check(counts["flash_attn_fwd"] == n_flash and by_d["flash_attn_fwd"] == {32: n_flash}
              and tc_counts["flash_attn_fwd"] == n_flash,
              f"flash_attn_fwd: {counts['flash_attn_fwd']} launches {by_d['flash_attn_fwd']}, "
              f"{tc_counts['flash_attn_fwd']} on the tensor cores; want {n_flash} at d = 32, "
              "all on flash_fwd_tc_tf32_kernel<32>")
        f32_gathers = (tk.bin_gather.f32_tc_launches, tk.bin_gather.sorted_launches)
        check(counts["binmax"] == 1 and counts["bin_gather"] == 1
              and tc_counts["binmax"] == 0 and tc_counts["bin_gather"] == 1
              and f32_gathers == (1, 1),
              f"binmax / bin_gather: {counts['binmax']} / {counts['bin_gather']} launches "
              f"({tc_counts['binmax']} / {tc_counts['bin_gather']} tensor-core, "
              f"{f32_gathers} f32 tensor-core / sorted by bin); want one f32 launch each for "
              "the 1,000 queries, the gather's on bin_gather_f32_tc_kernel over pairs sorted "
              "by bin")
        others = {k: v for k, v in counts.items()
                  if k not in ("flash_attn_fwd", "binmax", "bin_gather") and v}
        check(not others, f"kernels off the evaluation path launched: {others}")
        record["launches"] = {"flash_attn_fwd.f32": by_d["flash_attn_fwd"].get(32, 0),
                              "binmax.f32": counts["binmax"],
                              "bin_gather.f32": counts["bin_gather"]}
        check(len(ranked) == 1, f"{len(ranked)} rankings, want 1")
        q, d, k, kw, (vals, idx) = ranked.pop()
        check(q.shape == (EVAL_QUERIES, 384) and d.shape == (N_DOCS, 384) and k == 20
              and kw.get("block_rows") == block_rows_for(N_DOCS),
              f"ranked {tuple(q.shape)} against {tuple(d.shape)} at k = {k}, {kw}")
        pv, pi = cosine_topk_core(q, d, k)
        raw, untied = tie_mismatches(vals.cpu(), idx.cpu(), pv.cpu(), pi.cpu(), 1e-5)
        tie_rows = int((idx != pi).any(dim=1).sum().item())
        check(untied == 0, f"top-{k} ids: {untied} differ from cosine_topk_core but at ties")
        gap = ranking_gap(metrics, [[doc_ids[i] for i in row] for row in pi.cpu().tolist()],
                          qids, qrels, EVAL_KS, tie_rows)
        check(gap <= 1e-6, f"metrics {gap} from those of the plain ids (gate 1e-6)")
        # the encode against the same encode through plain attention
        sub = [corpus[x] for x in doc_ids[:CHUNKED_PASSAGES]]
        real_flash = ta.flash_attention
        ta.flash_attention = lambda q_, k_, v_, m=None: ta.flash_attention_plain(q_, k_, v_, m)
        try:
            plain_emb = torch.from_numpy(student.encode_documents(sub)).cuda()
        finally:
            ta.flash_attention = real_flash
        emb_slack = ((d[:CHUNKED_PASSAGES] - plain_emb).abs()
                     / (1e-4 * (1 + plain_emb.abs()))).max().item()
        check(emb_slack <= 1.0, f"embeddings vs plain attention: {emb_slack} of 1e-4 (1 + |x|)")
        record["retrieval"] = {
            "metrics": metrics, "queries": EVAL_QUERIES, "passages": N_DOCS,
            "launches": counts, "head_dim_launches": by_d, "tc_launches": tc_counts,
            "ids_differing_at_ties": raw, "tie_rows": tie_rows, "metric_gap_vs_plain": gap,
            "embedding_slack_vs_plain": emb_slack, **encode_s,
            "docs_per_s": N_DOCS / encode_s["encode_documents_s"],
        }
        record["kernels"] = eval_kernel_cases(q.contiguous(), d.contiguous(), args.seed + 301,
                                              build)
        del q, d, plain_emb, vals, idx, pv, pi
        timed.clear()

        # ---- evaluate_retrieval_chunked over 1,024 passages ---------------
        t0 = time.perf_counter()
        chunker = TextChunker(student.tokenizer, max_tokens=512, stride=80)
        chunk_texts, chunk_docs = [], []
        for j in range(CHUNKED_PASSAGES):
            pieces = chunker.chunk_text(passages[j])
            check(len(pieces) == 2, f"passage {j}: {len(pieces)} chunks, want 2")
            chunk_texts += [c.text for c in pieces]
            chunk_docs += [f"p{j}"] * len(pieces)
        sub_q = {qid: queries[qid] for qid, p in zip(qids, picks) if p < CHUNKED_PASSAGES}
        reset_launch_counts()
        chunked = ev.evaluate_retrieval_chunked(student, sub_q, chunk_texts, chunk_docs, qrels)
        torch.cuda.synchronize()
        parts_s["evaluate_retrieval_chunked"] = time.perf_counter() - t0
        c_counts, c_by_d = launch_counts(), head_dim_launch_counts()
        q, d, k, _, (vals, idx) = ranked.pop()
        scores = (q @ d.T).cpu()  # every chunk's plain score
        owner = np.asarray([int(x[1:]) for x in chunk_docs])
        want_rank, tie_rows = [], 0
        for r in range(scores.shape[0]):
            best = torch.full((CHUNKED_PASSAGES,), -np.inf).scatter_reduce(
                0, torch.from_numpy(owner), scores[r], "amax")
            top = torch.sort(best, descending=True, stable=True)
            want = [f"p{i}" for i in top.indices[: max(EVAL_KS)].tolist()]
            valid = idx[r] >= 0
            _, got = maxsim_aggregate_topk(vals[r][valid].cpu().numpy(),
                                           [chunk_docs[i] for i in idx[r][valid].tolist()],
                                           k=max(EVAL_KS))
            for a, b in zip(got, want):
                if a != b:
                    check(abs(float(best[int(a[1:])] - best[int(b[1:])])) <= 1e-5,
                          f"chunked ranking: {a} where the MaxSim of the plain scores has {b}")
            tie_rows += got != want
            want_rank.append(want)
        c_gap = ranking_gap(chunked, want_rank, list(sub_q), qrels, EVAL_KS, tie_rows)
        check(c_gap <= 1e-6, f"chunked metrics {c_gap} from the MaxSim of the plain scores")
        record["chunked"] = {
            "metrics": chunked, "queries": len(sub_q), "passages": CHUNKED_PASSAGES,
            "chunks": len(chunk_texts), "fetch_k": k, "tie_rows": tie_rows,
            "metric_gap_vs_plain": c_gap, "launches": c_counts, "head_dim_launches": c_by_d,
            **timed, "seconds": parts_s["evaluate_retrieval_chunked"],
        }
        log(f"[eval] chunked: {json.dumps(record['chunked'])}")
        del q, d, scores
        timed.clear()

        # ---- evaluate_retrieval_reranked with the full-width teacher ------
        t0 = time.perf_counter()
        teacher = TeacherModel(str(ROOT / "build" / "chip_smoke" / "teacher"), device="cuda")
        tcfg = teacher.config
        check((tcfg.num_layers, tcfg.hidden_size, tcfg.num_heads) == (24, 1024, 16)
              and tcfg.compute_dtype == torch.float32, f"not the full-width teacher: {tcfg}")
        parts_s["teacher_load"] = time.perf_counter() - t0
        scored: list = []
        real_score = teacher.score

        def recording_score(pairs, batch_size=32):
            out = real_score(pairs, batch_size)
            scored.append((list(pairs), out))
            return out

        teacher.score = recording_score
        rr_q = dict(list(sub_q.items())[:RERANK_QUERIES])
        check(len(rr_q) == RERANK_QUERIES, f"{len(rr_q)} rerank queries")
        rr_corpus = {f"p{j}": passages[j] for j in range(CHUNKED_PASSAGES)}
        t0 = time.perf_counter()
        reset_launch_counts()
        reranked = ev.evaluate_retrieval_reranked(student, teacher, rr_q, rr_corpus, qrels,
                                                  rerank_k=RERANK_K)
        torch.cuda.synchronize()
        parts_s["evaluate_retrieval_reranked"] = time.perf_counter() - t0
        r_counts, r_by_d, r_tc = launch_counts(), head_dim_launch_counts(), tc_launch_counts()
        pairs, flat = scored.pop()
        n_chunks = -(-len(pairs) // 256)
        check(len(pairs) == RERANK_QUERIES * RERANK_K, f"{len(pairs)} rerank pairs")
        # the teacher's flash at d = 64, and the student's encode of the
        # candidates at d = 32 (f32): every launch on the tensor cores
        check(r_by_d["flash_attn_fwd"].get(64, 0) == tcfg.num_layers * n_chunks
              and r_tc["flash_attn_fwd"] == sum(r_by_d["flash_attn_fwd"].values()),
              f"rerank flash: {r_by_d['flash_attn_fwd']}, {r_tc['flash_attn_fwd']} on the "
              f"tensor cores; want {tcfg.num_layers * n_chunks} at d = 64, every launch on "
              "flash_fwd_tc_tf32_kernel<64> / <32>")
        # each query's candidates again through TeacherModel.score, on their own
        q_, _, _, _, (_, cand) = ranked.pop()
        rr_ids = list(rr_corpus)
        want_rank, tie_rows, worst = [], 0, 0.0
        for r, qid in enumerate(rr_q):
            docs = [rr_ids[i] for i in cand[r].tolist() if i >= 0]
            mine = real_score([(rr_q[qid], rr_corpus[x]) for x in docs], batch_size=32)
            theirs = flat[r * RERANK_K : (r + 1) * RERANK_K]
            worst = max(worst, max(abs(a - b) / (1 + abs(b)) for a, b in zip(theirs, mine)))
            want = [docs[i] for i in np.argsort(-np.asarray(mine), kind="stable")]
            got = [docs[i] for i in np.argsort(-np.asarray(theirs), kind="stable")]
            for a, b in zip(got, want):
                if a != b:
                    check(abs(mine[docs.index(a)] - mine[docs.index(b)]) <= 1e-4,
                          f"rerank {qid}: {a} where TeacherModel.score orders {b}")
            tie_rows += got != want
            want_rank.append(want)
        check(worst <= 1e-4, f"rerank scores vs TeacherModel.score alone: {worst} (1 + |s|)")
        ks = [x for x in EVAL_KS if x <= RERANK_K]
        r_gap = ranking_gap(reranked, want_rank, list(rr_q), qrels, ks, tie_rows)
        check(r_gap <= 1e-6, f"reranked metrics {r_gap} from TeacherModel.score's order")
        record["reranked"] = {
            "metrics": reranked, "queries": RERANK_QUERIES, "rerank_k": RERANK_K,
            "pairs": len(pairs), "score_gap_vs_alone": worst, "tie_rows": tie_rows,
            "metric_gap": r_gap, "launches": r_counts, "head_dim_launches": r_by_d,
            "tc_launches": r_tc, "seconds": parts_s["evaluate_retrieval_reranked"],
        }
        log(f"[eval] reranked: {json.dumps(record['reranked'])}")
        del q_

        # ---- evaluate_ranking_quality against the teacher's scores --------
        t0 = time.perf_counter()
        qq = [queries[qid] for qid in qids[:QUALITY_QUERIES]]
        docs_per_q = []
        for p in picks[:QUALITY_QUERIES]:
            others = [int(x) for x in rng.choice(N_DOCS, QUALITY_DOCS, replace=False) if x != p]
            docs_per_q.append([passages[p]] + [passages[x] for x in others[: QUALITY_DOCS - 1]])
        t_flat = real_score([(qt, doc) for qt, docs in zip(qq, docs_per_q) for doc in docs],
                            batch_size=256)
        t_scores = np.asarray(t_flat).reshape(QUALITY_QUERIES, QUALITY_DOCS)
        binary = [[1] + [0] * (QUALITY_DOCS - 1)] * QUALITY_QUERIES
        quality = ev.evaluate_ranking_quality(student, qq, docs_per_q, t_scores.tolist(), binary)
        parts_s["evaluate_ranking_quality"] = time.perf_counter() - t0
        taus = []
        for query, docs, ts in zip(qq, docs_per_q, t_scores):
            s = (student.encode_queries([query]) @ student.encode_documents(docs).T)[0]
            taus.append(kendalltau(s.astype(np.float64), ts)[0])
        tau_gap = abs(quality["kendall_tau"] - float(np.mean(taus)))
        check(tau_gap <= 1e-6, f"Kendall tau {quality['kendall_tau']} vs scipy's "
              f"{np.mean(taus)}")
        record["ranking_quality"] = {**quality, "scipy_kendall_tau": float(np.mean(taus)),
                                     "tau_gap": tau_gap,
                                     "seconds": parts_s["evaluate_ranking_quality"]}
        log(f"[eval] ranking quality: {json.dumps(record['ranking_quality'])}")
        teacher.score = real_score
        del teacher
    finally:
        kd_eval.cosine_topk = real_topk
    torch.cuda.empty_cache()
    record["parts_seconds"] = parts_s
    return record


def phase_eval(args, build: dict) -> dict:
    """Evaluation on the card: (a) the repository's JAX checkpoints and the
    gate, (b) the evaluator at full width, (c) the native tokenizer core."""
    t0 = time.perf_counter()
    record = {"checkpoints": eval_checkpoints()}
    record["checkpoints_seconds"] = time.perf_counter() - t0
    record.update(eval_full_width(args, build))
    return record


# ---------------------------------------------------------------------------
# The pipeline phase: run_train_pipeline end to end
# ---------------------------------------------------------------------------

# scripts/run_demo_pipeline.sh's recipe for `train` (lr, eval_steps, patience,
# in-batch negatives, confidence 0.0, 12 epochs, batch 16, stage 2)
DEMO_RECIPE = {
    "training": {"learning_rate": 2e-3, "eval_steps": 16, "early_stopping_patience": 12,
                 "epochs": 12, "batch_size": 16},
    "loss": {"in_batch_negatives": True},
    "mining": {"teacher_confidence_threshold": 0.0, "stage": 2},
}
TINY_SAMPLES = 48  # the --tiny run's generated demo rows
FULL_QUERIES = 128  # the full-width run's queries (bm25 top 100: about 12,800 teacher pairs)
PIPELINE_KS = ("ndcg@10", "mrr@10", "recall@10", "ndcg@20")


@contextlib.contextmanager
def pipeline_probe():
    """While open: the wall time of each step of run_train_pipeline (from
    its "[k/7]" log records) and the pairs and seconds of every
    TeacherModel.score call (mining's stage 2). Yields the dict it fills."""
    import logging

    from sskd_tpu_torch.models.teacher import TeacherModel

    probe = {"marks": [], "score_pairs": 0, "score_seconds": 0.0}

    class Marks(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("[") and "/7]" in msg[:6]:
                probe["marks"].append((msg[:5], time.perf_counter()))

    lg = logging.getLogger("sskd_tpu_torch.pipeline")
    handler, saved = Marks(), (lg.level, lg.propagate)
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    score = TeacherModel.score

    def counted(self, pairs, batch_size=32):
        t0 = time.perf_counter()
        out = score(self, pairs, batch_size=batch_size)
        torch.cuda.synchronize()
        probe["score_seconds"] += time.perf_counter() - t0
        probe["score_pairs"] += len(pairs)
        return out

    TeacherModel.score = counted
    t0 = time.perf_counter()
    try:
        yield probe
    finally:
        TeacherModel.score = score
        lg.removeHandler(handler)
        lg.setLevel(saved[0])
        lg.propagate = saved[1]
        ends = [t for _, t in probe["marks"][1:]] + [time.perf_counter()]
        probe["step_seconds"] = {m: e - t for (m, t), e in zip(probe["marks"], ends)}
        probe["seconds"] = time.perf_counter() - t0
        del probe["marks"]


@contextlib.contextmanager
def dropattn_shapes():
    """While open: the [B, h, L, d] of every dropattn_fwd and dropattn_bwd
    launch of the training path (ops.attention._DropoutAttention), with
    their counts. Yields {"dropattn_fwd": {"BxhxLxd": n}, "dropattn_bwd":
    {...}}."""
    from sskd_tpu_torch.ops import attention as ta

    seen = {"dropattn_fwd": {}, "dropattn_bwd": {}}
    cls = ta._DropoutAttention
    fwd, bwd = cls.forward, cls.backward

    def tally(name, t):
        key = "x".join(str(n) for n in t.shape)
        seen[name][key] = seen[name].get(key, 0) + 1

    def forward(ctx, q, *rest):
        tally("dropattn_fwd", q)
        return fwd(ctx, q, *rest)

    def backward(ctx, g):
        tally("dropattn_bwd", g)
        return bwd(ctx, g)

    cls.forward, cls.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield seen
    finally:
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)


def dropattn_shape_times(shape: str, p: float = 0.1) -> dict:
    """The device ms of one f32 dropattn_fwd and one dropattn_bwd launch at
    ``shape`` ("BxhxLxd", seeded inputs, no padding), CUDA events behind a
    held stream, with each one's route."""
    from sskd_tpu_torch.ops import attention as ta

    B, h, L, d = (int(n) for n in shape.split("x"))
    g = torch.Generator(device="cuda").manual_seed(B + L)
    q, k, v, go = (torch.randn(B, h, L, d, device="cuda", generator=g) for _ in range(4))
    bias = torch.zeros(B, L, device="cuda")
    _, lse = ta.dropattn_fwd(q, k, v, bias, p, 5)
    return {"shape": [B, h, L, d], "p": p,
            "fwd_route": ta.dropattn_fwd_route(q.dtype, d, L),
            "bwd_route": ta.dropattn_bwd_route(q.dtype, d, L),
            "fwd_device_ms": stream_device_ms(lambda: ta.dropattn_fwd(q, k, v, bias, p, 5), 8),
            "bwd_device_ms": stream_device_ms(
                lambda: ta.dropattn_bwd(q, k, v, bias, p, 5, lse, go), 8)}


def finite_losses(result: dict) -> int:
    """Checks every loss term of every epoch record is finite; returns how
    many there were."""
    losses = [v for rec in result["history"] for k, v in rec.items()
              if isinstance(v, float) and ("loss" in k or k in ("margin_mse", "listwise_kd",
                                                                "contrastive"))]
    check(losses and all(math.isfinite(v) for v in losses), f"a loss is not finite: {losses}")
    return len(losses)


def mined_vs_file(got: list, want: list) -> dict:
    """The mined negatives against the JAX run's file: per query the same
    ids, each score within 1e-4 (1 + |s|) of the file's; where the order
    differs, the file's scores of the swapped ids lie within that bound of
    each other."""
    worst, swapped = 0.0, 0
    check(len(got) == len(want), f"{len(got)} mined queries, the file has {len(want)}")
    for qi, (g, w) in enumerate(zip(got, want)):
        ws = dict(zip(w["doc_ids"], w["scores"]))
        check(sorted(g.doc_ids) == sorted(w["doc_ids"]), f"query {qi}: mined ids differ: "
              f"{g.doc_ids} against {w['doc_ids']}")
        for i, (d, sc) in enumerate(zip(g.doc_ids, g.scores)):
            gap = abs(sc - ws[d]) / (1 + abs(ws[d]))
            worst = max(worst, gap)
            check(gap <= 1e-4, f"query {qi}: {d} scored {sc}, the file {ws[d]}")
            if d != w["doc_ids"][i]:
                other = w["scores"][i]
                swapped += 1
                check(abs(ws[d] - other) <= 1e-4 * (1 + abs(other)),
                      f"query {qi}: {d} and {w['doc_ids'][i]} swapped, not a near tie")
    return {"queries": len(got), "max_score_gap": worst, "swapped": swapped}


def pipeline_demo(work: Path) -> dict:
    """(a) The demo recipe over the repository's demo run: the raw splits
    copied, the teacher and the student init (artifacts/demo/{teacher,
    vanilla}, the JAX KD run's own, read from params.msgpack), stage 2 with
    the validation split as the dev evaluator; the 420 queries' negatives
    against run_kd/mined_stage2.json, the KD student on test.jsonl against
    the vanilla init. The student computes in f32: every dropattn_fwd
    launch on the tensor cores (dropattn_fwd_tc_tf32_kernel<32>)."""
    import shutil

    from sskd_tpu_torch.cli.pipeline import load_eval_inputs, run_train_pipeline
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.kd.eval import KDEvaluator
    from sskd_tpu_torch.mining.miners import MinedNegatives
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import (
        head_dim_launch_counts,
        launch_counts,
        reset_launch_counts,
        tc_launch_counts,
    )

    raw = work / "data" / "raw" / "demo"
    raw.mkdir(parents=True)
    for f in (DEMO / "data" / "raw" / "demo").iterdir():
        shutil.copy(f, raw / f.name)
    recipe = dict(DEMO_RECIPE, student={"model_name": str(DEMO / "vanilla")},
                  teacher={"model_name": str(DEMO / "teacher")})
    reset_launch_counts()
    with pipeline_probe() as probe, dropattn_shapes() as shapes:
        result = run_train_pipeline(Settings.from_dict(recipe), data_dir=work / "data",
                                    output_dir=work / "run_kd", dataset="demo",
                                    dev_data=raw / "validation.jsonl", device="cuda")
    torch.cuda.synchronize()
    launches, by_d, tc = launch_counts(), head_dim_launch_counts(), tc_launch_counts()
    mined = [MinedNegatives(**m) for m in json.loads((work / "run_kd" / "mined_stage2.json")
                                                     .read_text())]
    want = json.loads((DEMO / "run_kd" / "mined_stage2.json").read_text())
    out = {"mined_vs_file": mined_vs_file(mined, want), "losses": finite_losses(result),
           "global_step": result["global_step"], "best_dev_ndcg@10": result["best_metric"],
           "launches": launches, "head_dim_launches": by_d, "tc_launches": tc,
           "dropattn_shapes": shapes, **probe}
    check(sum(shapes["dropattn_fwd"].values()) == launches["dropattn_fwd"]
          and sum(shapes["dropattn_bwd"].values()) == launches["dropattn_bwd"],
          f"the demo run's dropattn shapes {shapes} do not sum to its launches {launches}")
    check(by_d["dropattn_fwd"].get(32, 0) > 0 and by_d["dropattn_bwd"].get(32, 0) > 0,
          f"the demo student (head dim 32) launched no dropattn kernel: {by_d}")
    # the student computes in f32: every forward on dropattn_fwd_tc_tf32_kernel<32>
    check(tc["dropattn_fwd"] == launches["dropattn_fwd"],
          f"a dropattn_fwd launch of the demo run left the tensor cores: {tc}, {by_d}")
    out["top_shape"] = dropattn_shape_times(max(shapes["dropattn_bwd"],
                                                key=shapes["dropattn_bwd"].get))
    best = StudentModel(str(work / "run_kd" / "best_model"), device="cuda")
    inputs = load_eval_inputs(DEMO_TEST, 600)
    kd = KDEvaluator(device="cuda").evaluate_retrieval(best, *inputs)
    recorded = {name: json.loads((DEMO / f"{name}_metrics.json").read_text())
                for name in ("vanilla", "kd_student", "teacher")}
    out["kd_student"] = {k: kd[k] for k in PIPELINE_KS}
    out["jax_files"] = {name: {k: m[k] for k in PIPELINE_KS} for name, m in recorded.items()}
    threshold = 0.95 * recorded["teacher"]["ndcg@10"]
    out["gate"] = {"threshold": threshold, "kd_passes": bool(kd["ndcg@10"] >= threshold),
                   "enforced": False}
    log(f"[pipeline] (a) demo: {json.dumps(out)}")
    check(kd["ndcg@10"] > recorded["vanilla"]["ndcg@10"],
          f"the KD student's nDCG@10 {kd['ndcg@10']:.4f} is not above the vanilla init's "
          f"{recorded['vanilla']['ndcg@10']:.4f}")
    return out


def pipeline_tiny(work: Path) -> dict:
    """(b) The --tiny defaults at head dim 16: TINY_SAMPLES generated demo
    rows prepared to parquet through the port's writer, require_integrity,
    run_train_pipeline at stage 3 with BertConfig.tiny for both models (the
    student in bf16, as configs/kd.yaml's precision computes; the teacher
    in f32), 1 epoch, confidence 0.0; then 4 TeacherTrainer steps of the
    tiny teacher in f32 as `train-teacher --tiny` runs them (batch 32,
    max_len 64, the corpus-fitted vocabulary). Every dropattn launch of the
    student at d = 16 on the tensor cores, the teacher's forward on the
    tensor cores too (dropattn_fwd_tc_tf32_kernel<16>) and its backward
    streaming. Between the two, the trained student's encode at L = 512
    (tiny_encode_512: flash at d = 16 on the tensor cores)."""
    from dataclasses import replace

    from sskd_tpu_torch.cli.pipeline import run_train_pipeline
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.data.demo import generate_demo_dataset
    from sskd_tpu_torch.data.integrity import require_integrity
    from sskd_tpu_torch.data.prepare import prepare_dataset
    from sskd_tpu_torch.kd.teacher_train import TeacherTrainer, triples_from_raw
    from sskd_tpu_torch.models.bert import BertConfig
    from sskd_tpu_torch.models.teacher import TeacherModel
    from sskd_tpu_torch.ops import head_dim_launch_counts, reset_launch_counts, tc_launch_counts
    from sskd_tpu_torch.ops import attention as ta
    from sskd_tpu_torch.tokenization import WordPieceTokenizer

    data = work / "data"
    t0 = time.perf_counter()
    generate_demo_dataset(data / "raw" / "demo", num_samples=TINY_SAMPLES)
    manifest = prepare_dataset(data, dataset="demo")
    require_integrity(data, "demo")
    prep_s = time.perf_counter() - t0
    settings = Settings.from_dict({"mining": {"teacher_confidence_threshold": 0.0}})
    reset_launch_counts()
    with pipeline_probe() as probe:
        result = run_train_pipeline(
            settings, data_dir=data, output_dir=work / "run", dataset="demo", stage=3, epochs=1,
            student_config=BertConfig.tiny(compute_dtype=torch.bfloat16),
            teacher_config=BertConfig.tiny(), device="cuda")
    torch.cuda.synchronize()
    by_d, tc = head_dim_launch_counts(), tc_launch_counts()
    student = {k: by_d[k].get(16, 0) for k in ("dropattn_fwd", "dropattn_bwd")}
    check(min(student.values()) > 0 and sum(by_d["dropattn_fwd"].values()) == student[
        "dropattn_fwd"], f"the tiny student's dropattn launches: {by_d}")
    check(tc["dropattn_fwd"] == student["dropattn_fwd"] and tc["dropattn_bwd"]
          == student["dropattn_bwd"], f"a bf16 d=16 launch left the tensor cores: {tc}")
    # the resident route tools/probe_dropattn16.py chose for bf16 at d = 16: every
    # backward that held its head took the three-pass kernel
    check(ta.dropattn_bwd.three_pass_launches > 0 and ta.dropattn_bwd.three_pass_launches
          + ta.dropattn_bwd.stream_launches == student["dropattn_bwd"],
          f"the tiny student's d=16 backwards: {ta.dropattn_bwd.three_pass_launches} of "
          f"{student['dropattn_bwd']} on dropattn_bwd_tc_3pass_kernel, "
          f"{ta.dropattn_bwd.stream_launches} streaming")
    out = {"prepare_seconds": prep_s, "chunks": {k: v["num_chunks"]
                                                 for k, v in manifest["splits"].items()},
           "losses": finite_losses(result), "global_step": result["global_step"],
           "student_launches": student, **probe}
    triples = triples_from_raw(data / "raw" / "demo" / "train.jsonl")
    out["encode_512"] = tiny_encode_512(work / "run" / "best_model",
                                        sorted({d for _, d, _ in triples}))
    # train-teacher --tiny: the corpus-fitted vocabulary, 4 steps in f32
    texts = sorted({q for q, _, _ in triples} | {d for _, d, _ in triples})
    tok = WordPieceTokenizer.build_from_corpus(texts, vocab_size=2048)
    teacher = TeacherModel("tiny-teacher", device="cuda", tokenizer=tok,
                           config=replace(BertConfig.tiny(), vocab_size=tok.vocab_size))
    reset_launch_counts()
    t0 = time.perf_counter()
    tr = TeacherTrainer(teacher).train(triples, steps=4, batch_size=32, max_len=64)
    torch.cuda.synchronize()
    by_d = head_dim_launch_counts()
    f32 = {k: by_d[k].get(16, 0) for k in ("dropattn_fwd", "dropattn_bwd")}
    check(f32["dropattn_fwd"] > 0 and f32["dropattn_bwd"] == ta.dropattn_bwd.stream_launches
          and ta.dropattn_fwd.tc_launches == f32["dropattn_fwd"],
          f"the tiny teacher's dropattn launches at d = 16: {by_d}, "
          f"{ta.dropattn_fwd.tc_launches} forwards on the tensor cores")
    check(math.isfinite(tr["final_loss"]), f"the tiny teacher's loss {tr['final_loss']}")
    out["teacher"] = {"steps": tr["steps"], "final_loss": tr["final_loss"],
                      "seconds": time.perf_counter() - t0, "launches": f32}
    out["d16_launches"] = {"flash_attn_fwd.d16": out["encode_512"]["flash_launches"],
                           "dropattn_fwd.d16": student["dropattn_fwd"],
                           "dropattn_bwd.d16": student["dropattn_bwd"],
                           "dropattn_fwd.d16.f32": f32["dropattn_fwd"],
                           "dropattn_bwd.d16.f32": f32["dropattn_bwd"]}
    log(f"[pipeline] (b) tiny: {json.dumps(out)}")
    return out


TINY_ENCODE_DOCS = 256  # passages of at least 512 tokens: one batch at L = 512


def tiny_encode_512(checkpoint: Path, passages: list[str]) -> dict:
    """The trained tiny student (bf16, as the --tiny run computes) encodes
    TINY_ENCODE_DOCS passages of at least 512 tokens, each the corpus's
    passages joined from a different start, through encode_documents: one
    batch at L = 512, where each of its 2 layers takes flash at
    [256, 4, 512, 16] on the tensor cores (flash_fwd_tc2_kernel<16, 2, 4>).
    Checks the launches (2, each on the route and at d = 16) and each
    embedding's cosine with the same checkpoint's on the CPU (plain
    versions, bf16) at least 0.999; records the encode's docs/s."""
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import attention as ta

    student = StudentModel(str(checkpoint), device="cuda", compute_dtype=torch.bfloat16)
    sizes = [len(student.tokenizer.tokenize(t)) for t in passages]
    texts = []
    for i in range(TINY_ENCODE_DOCS):
        parts, n, j = [], 0, i
        while n < 520:
            parts.append(passages[j % len(passages)])
            n += sizes[j % len(passages)]
            j += 1
        texts.append(" ".join(parts))
    width = student.tokenize_batch([student.passage_prefix + t for t in texts])["input_ids"].shape
    check(tuple(width) == (TINY_ENCODE_DOCS, 512), f"the tiny encode's batch is {width}")
    before = (ta.flash_attention.launches, ta.flash_attention.tc_launches,
              ta.flash_attention.head_dim_launches.get(16, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = student.encode_documents(texts, batch_size=TINY_ENCODE_DOCS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [ta.flash_attention.launches - before[0], ta.flash_attention.tc_launches
                - before[1], ta.flash_attention.head_dim_launches.get(16, 0) - before[2]]
    layers = student.config.num_layers
    check(launches == [layers] * 3, f"the tiny encode at L = 512: flash launches (all, tensor "
          f"cores, d = 16) {launches}, want {layers} each")
    cpu = StudentModel(str(checkpoint), device="cpu", compute_dtype=torch.bfloat16)
    want = cpu.encode_documents(texts, batch_size=32)
    cos = (got * want).sum(axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    check(got.shape == want.shape and bool(np.isfinite(got).all()) and cos.min() >= 0.999,
          f"the tiny encode at L = 512 against the CPU: min cosine {cos.min()}")
    return {"docs": TINY_ENCODE_DOCS, "L": 512, "flash_launches": launches[0],
            "min_cosine_vs_cpu": float(cos.min()), "seconds": seconds,
            "docs_per_s": TINY_ENCODE_DOCS / seconds}


def pipeline_full(work: Path) -> dict:
    """(c) Full width: e5-small-v2 (bf16 compute, f32 parameters) and
    bge-reranker-large (f32), seeded weights and the vocabulary fitted to
    the corpus (2,048, as the pipeline fits it for any config it is
    handed), stage 3 over FULL_QUERIES queries of the port's demo data, bm25
    top 100, batch 32, 1 epoch. Seconds per step and the teacher's pairs a
    second."""
    from sskd_tpu_torch.cli.pipeline import run_train_pipeline
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.data.demo import generate_demo_dataset
    from sskd_tpu_torch.models.bert import BertConfig
    from sskd_tpu_torch.ops import head_dim_launch_counts, reset_launch_counts, tc_launch_counts

    data = work / "data"
    # the train split's share is 0.8: this many rows keep FULL_QUERIES in it
    generate_demo_dataset(data / "raw" / "demo", num_samples=FULL_QUERIES * 5 // 4)
    settings = Settings.from_dict({"mining": {"teacher_confidence_threshold": 0.0},
                                   "training": {"batch_size": 32}})
    reset_launch_counts()
    with pipeline_probe() as probe:
        result = run_train_pipeline(
            settings, data_dir=data, output_dir=work / "run", dataset="demo", stage=3, epochs=1,
            student_config=BertConfig.e5_small_v2(compute_dtype=torch.bfloat16),
            teacher_config=BertConfig.bge_reranker_large(), device="cuda")
    torch.cuda.synchronize()
    by_d, tc = head_dim_launch_counts(), tc_launch_counts()
    mined = json.loads((work / "run" / "mined_stage3.json").read_text())
    with_negs = sum(1 for m in mined if m["doc_ids"])
    out = {"queries": result["num_queries"], "corpus": result["corpus_size"],
           "with_negatives": with_negs, "losses": finite_losses(result),
           "global_step": result["global_step"], "head_dim_launches": by_d, **probe}
    out["pairs_per_s"] = probe["score_pairs"] / max(probe["score_seconds"], 1e-9)
    check(result["num_queries"] == FULL_QUERIES, f"{result['num_queries']} queries")
    check(with_negs > len(mined) // 2, f"{with_negs} of {len(mined)} queries mined negatives")
    check(all(len(m["doc_ids"]) == len(set(m["doc_ids"])) <= 5 + settings.mining.ance_top_k
              for m in mined), "a stage-3 union is not at most 5 teacher ids and the ANCE picks")
    d32 = {k: by_d[k].get(32, 0) for k in ("dropattn_fwd", "dropattn_bwd")}
    check(min(d32.values()) > 0 and tc["dropattn_fwd"] == d32["dropattn_fwd"]
          and tc["dropattn_bwd"] == d32["dropattn_bwd"],
          f"the full-width student's dropattn launches at d = 32 left the tensor cores: {by_d}")
    log(f"[pipeline] (c) full width: {json.dumps(out)}")
    return out


def phase_pipeline(args) -> dict:
    """run_train_pipeline on the card: (a) the demo recipe over the
    repository's demo run, (b) the --tiny defaults at head dim 16, (c) full
    width. Each part in its own directory under build/chip_smoke."""
    import shutil

    base = ROOT / "build" / "chip_smoke" / "pipeline"
    shutil.rmtree(base, ignore_errors=True)
    record = {}
    for name, part in (("demo", pipeline_demo), ("tiny", pipeline_tiny), ("full", pipeline_full)):
        t0 = time.perf_counter()
        record[name] = part(base / name)
        record[name]["part_seconds"] = time.perf_counter() - t0
        log(f"[pipeline] ({name}) took {record[name]['part_seconds']:.1f} s")
    shutil.rmtree(base, ignore_errors=True)
    return record


# ---------------------------------------------------------------------------
# The cli phase: the port's own entry point, semantic-kd-torch, as subprocesses
# ---------------------------------------------------------------------------

CLI_QUERIES = 64  # /search against the plain engine over /encode's embeddings
CLI_SEQUENTIAL = 200  # distinct /search requests from one client, timed
# the JAX package's production audit of the default settings
DEFAULT_AUDIT = ["cors.allow_origins contains wildcard", "auth.enabled is False",
                 "rate_limit.enabled is False"]


def cli_run(argv: list, seconds: dict, tag: str, expect_rc: int = 0, timeout: float = 300,
            env: dict | None = None) -> str:
    """``python -m sskd_tpu_torch.cli.main *argv`` on the card; checks its exit
    code, records its seconds under ``tag``, returns its standard output."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "sskd_tpu_torch.cli.main", *map(str, argv)],
                         cwd=ROOT, env={**os.environ, **(env or {})}, capture_output=True,
                         text=True, timeout=timeout)
    seconds[tag] = time.perf_counter() - t0
    check(out.returncode == expect_rc, f"semantic-kd-torch {tag}: exit {out.returncode}, want "
          f"{expect_rc}: {out.stderr[-1500:]}")
    return out.stdout


@contextlib.contextmanager
def cli_server(argv: list, seconds: dict, tag: str, env: dict | None = None):
    """``semantic-kd-torch serve *argv`` on 127.0.0.1 in a process of its own;
    yields the port once /ready answers 200 (at most 300 s), then SIGTERM,
    which must end it with exit code 0 within 60 s."""
    port = free_port()
    log_path = ROOT / "build" / "chip_smoke" / "cli" / f"{tag}.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sskd_tpu_torch.cli.main", "serve", "--host", "127.0.0.1",
             "--port", str(port), *map(str, argv)],
            cwd=ROOT, env={**os.environ, **(env or {})}, stdout=log_file, stderr=log_file)
        try:
            while True:
                check(proc.poll() is None, f"{tag}: the server exited {proc.returncode} at "
                      f"startup: {log_path.read_text()[-1500:]}")
                check(time.perf_counter() - t0 < 300, f"{tag}: not ready after 300 s")
                try:
                    if get(port, "/ready") == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            seconds[f"{tag}.startup"] = time.perf_counter() - t0
            yield port
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            check(rc == 0, f"{tag}: SIGTERM ended the server with exit code {rc}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    seconds[tag] = time.perf_counter() - t0


def report_rows(report: str) -> dict:
    """The rows of a `compare` report's table, {model: {metric: value}}."""
    lines = [ln for ln in report.splitlines() if ln.startswith("| ")]
    head = [c.strip() for c in lines[0].strip("|").split("|")]
    return {cells[0]: dict(zip(head[1:], map(float, cells[1:])))
            for cells in ([c.strip() for c in ln.strip("|").split("|")] for ln in lines[1:])}


def phase_cli(args, eval_record: dict) -> dict:
    """The port's command line on the card, each command a process of its
    own, at full e5-small-v2 width (the serve phase's seeded student and
    1,000,000-row index under build/chip_smoke): index build / validate,
    serve under configs/service.yaml with the cache, auth and the rate
    limit on, serve with the hybrid arm, export, compare, the data commands
    and train --tiny, doctor and config. Every wait bounded; each command's
    seconds recorded."""
    import shutil

    from sskd_tpu_torch.data.parquet import write_parquet
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.keys import APIKeyManager
    from sskd_tpu_torch.mining.bm25 import BM25Index
    from sskd_tpu_torch.models.export import load_quantized_weights, quantize_param_tree
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.models.weights import jax_params_from_bi_encoder
    from sskd_tpu_torch.ops.topk import cosine_topk_core
    from sskd_tpu_torch.serve.hybrid import HybridSearcher

    base = ROOT / "build" / "chip_smoke"
    work = base / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    student_dir, big_index = base / "student", base / "index"
    seconds: dict = {}
    out: dict = {"seconds": seconds}

    data = work / "data"

    def pipeline():
        manifest = json.loads(cli_run(["demo-data", "--out", data / "raw" / "demo", "--samples",
                                       TINY_SAMPLES], seconds, "demo-data"))
        check(sum(s["num_samples"] for s in manifest["splits"].values()) == TINY_SAMPLES,
              f"demo-data: {manifest}")
        cli_run(["prepare", "--data-dir", data], seconds, "prepare")
        check(json.loads(cli_run(["integrity", "--data-dir", data], seconds, "integrity"))["ok"],
              "integrity")
        # as pipeline (b): the untrained teacher's confidence would filter every negative
        res = json.loads(cli_run(["train", "--tiny", "--epochs", "1", "--data-dir", data,
                                  "--output-dir", work / "run"], seconds, "train --tiny",
                                 timeout=600, env={
                                     "SEMANTIC_KD_MINING__TEACHER_CONFIDENCE_THRESHOLD": "0.0"}))
        history = json.loads((work / "run" / "history.json").read_text())
        losses = [v for rec in history for k, v in rec.items() if "loss" in k
                  and isinstance(v, float)]
        check(res["global_step"] > 0 and losses and all(math.isfinite(v) for v in losses),
              f"train --tiny: {res}, losses {losses}")
        return {"global_step": res["global_step"], "losses": losses}

    # the data commands and train --tiny run beside the index build (the
    # served latencies below are timed with nothing else on the card)
    side = ThreadPoolExecutor(5)
    chain_future = side.submit(pipeline)

    # 1-2. index build over the serve cell's passages, then validate
    passages = make_passages(N_DOCS, args.seed)
    chunk_ids = [f"chunk-{i}" for i in range(N_DOCS)]
    write_parquet(work / "chunks.parquet", {"chunk_id": chunk_ids, "text": passages})
    built = json.loads(cli_run(["index", "build", "--model", student_dir, "--data",
                                work / "chunks.parquet", "--out", work / "index", "--dtype",
                                "int8", "--method", "exact"], seconds, "index build",
                               timeout=600))
    check(built["ntotal"] == N_DOCS, f"index build: {built}")
    student = StudentModel(str(student_dir), device="cuda")
    want = IndexBuilder(student.embedding_dim, index_type="exact", dtype="int8",
                        device="cuda").build_from_parquet(student, work / "chunks.parquet")
    got = IndexBuilder(device="cuda").load(work / "index")
    check(np.array_equal(got._vectors, want._vectors) and np.array_equal(got._scales, want._scales)
          and got.doc_ids == want.doc_ids, "the CLI's index rows differ from an in-process build")
    del want, student
    report = json.loads(cli_run(["index", "validate", "--dir", work / "index"], seconds,
                                "index validate"))
    check(report["passed"], f"index validate: {report}")
    out["validate_recall@10"] = report["recall@10"]
    out["pipeline"] = chain_future.result()

    # 3. serve the 1M-row index under configs/service.yaml, cache + auth + rate limit
    keys = APIKeyManager(work / "keys.json")
    key = keys.generate("chip-smoke")
    env = {"SEMANTIC_KD_CONFIG_PATH": str(ROOT / "configs" / "service.yaml"),
           "SEMANTIC_KD_CACHE__ENABLED": "true", "SEMANTIC_KD_AUTH__ENABLED": "true",
           "SEMANTIC_KD_AUTH__API_KEY_HASHES": keys.export_env(),
           "SEMANTIC_KD_RATE_LIMIT__ENABLED": "true"}
    rng = np.random.default_rng(args.seed + 10)
    queries = [" ".join(rng.choice(WORDS, 6)) for _ in range(CLI_QUERIES + CLI_SEQUENTIAL)]
    check(len(set(queries)) == len(queries), "the phase's queries repeat")
    served, encoded = [], []
    serve_out: dict = {}
    with cli_server(["--index", big_index, "--model", student_dir], seconds, "serve", env) as port:
        auth = {"X-API-Key": key}

        def as_client(name: str) -> dict:  # each client its own token bucket
            return {**auth, "X-Forwarded-For": name}

        status, body, _ = request(port, "POST", "/search", {"query": queries[0]},
                                  {"X-Forwarded-For": "anonymous"})
        check(status == 401, f"/search without a key: HTTP {status} {body}")
        for path in ("/docs", "/openapi.json"):
            check(request(port, "GET", path, headers=as_client("docs"))[0] == 200, path)
        check(request(port, "GET", "/metrics", headers=auth)[0] == 200, "/metrics")
        for i, q in enumerate(queries[:CLI_QUERIES]):
            status, body, _ = request(port, "POST", "/search", {"query": q, "k": 10},
                                      as_client(f"q{i}"))
            check(status == 200 and body["cached"] is False, f"/search {q!r}: {status} {body}")
            served.append([r["doc_id"] for r in body["results"]])
            status, enc, _ = request(port, "POST", "/encode", {"texts": ["query: " + q]},
                                     as_client(f"e{i}"))
            check(status == 200, f"/encode {q!r}: {status}")
            encoded.append(enc["embeddings"][0])
        status, body, _ = request(port, "POST", "/search", {"query": queries[0], "k": 10},
                                  as_client("repeat"))
        check(status == 200 and body["cached"] is True and
              [r["doc_id"] for r in body["results"]] == served[0], f"repeat: {body}")
        # configs/service.yaml: a burst of 10, then a token a second
        burst = [request(port, "POST", "/search", {"query": queries[0], "k": 10},
                         as_client("burst"))[0] for _ in range(12)]
        check(burst[:10] == [200] * 10 and burst[-1] == 429, f"the burst's statuses: {burst}")
        serve_out["burst"] = burst
        lat = []
        t0 = time.perf_counter()
        for i, q in enumerate(queries[CLI_QUERIES:]):
            status, body, ms = request(port, "POST", "/search", {"query": q, "k": 10},
                                       as_client(f"s{i}"))
            check(status == 200, f"sequential /search: {status} {body}")
            lat.append(ms)
        wall = time.perf_counter() - t0
        serve_out["sequential"] = {"requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
                                   "p99_ms": float(np.percentile(lat, 99)),
                                   "queries_per_s": len(lat) / wall}
        status, body, _ = request(port, "POST", "/index/load",
                                  {"index_dir": str(work / "index")}, as_client("load"))
        check(status == 200 and body["index_size"] == N_DOCS, f"/index/load: {status} {body}")
        status, body, _ = request(port, "POST", "/search", {"query": queries[0], "k": 10},
                                  as_client("after-load"))
        check(status == 200 and body["cached"] is False and
              all(r["doc_id"].startswith("chunk-") for r in body["results"]),
              f"after /index/load the result cache was not flushed: {body}")
        status, health, _ = request(port, "GET", "/health")
        check(health["index_size"] == N_DOCS, f"/health after the swap: {health}")
        metrics = request(port, "GET", "/metrics", headers=auth)[1]
        check('semantic_kd_cache_hits_total{cache="result"}' in metrics and
              f"semantic_kd_rate_limit_hits_total {float(burst.count(429))!r}" in metrics,
              "the cache and rate-limit counters")
    # every served id list against the plain engine on /encode's embeddings
    b = IndexBuilder(device="cuda").load(big_index)
    b.ensure_device()
    emb = torch.tensor(encoded, dtype=torch.float32, device="cuda")
    _, pi = cosine_topk_core(emb, b.device_vectors, 10, row_scales=b.device_scales,
                             valid_n=b.ntotal)
    plain = [[b.doc_ids[i] for i in row] for row in pi.cpu().tolist()]
    serve_out["mismatched_queries"] = sum(g != w for g, w in zip(served, plain))
    check(serve_out["mismatched_queries"] == 0,
          f"{serve_out['mismatched_queries']} of {CLI_QUERIES} queries differ from the plain engine")
    del b, emb
    torch.cuda.empty_cache()
    out["serve"] = serve_out
    log(f"[cli] serve: {json.dumps(serve_out)}")

    # 4-8. the hybrid arm, export, compare, doctor and config: independent
    # of each other, run side by side

    def hybrid_arm():
        """The hybrid arm over a BM25 index of the same passages."""
        BM25Index().build(passages, chunk_ids).save(work / "bm25")
        fused_served, fused_enc = [], []
        with cli_server(["--index", work / "index", "--model", student_dir, "--hybrid-bm25",
                         work / "bm25"], seconds, "serve hybrid") as port:
            for q in queries[:8]:
                status, body, _ = request(port, "POST", "/search", {"query": q, "k": 10})
                check(status == 200 and body["hybrid"] is True, f"hybrid /search: {status} {body}")
                fused_served.append([r["doc_id"] for r in body["results"]])
                fused_enc.append(request(port, "POST", "/encode",
                                         {"texts": ["query: " + q]})[1]["embeddings"][0])
        small = IndexBuilder(device="cuda").load(work / "index")
        small.ensure_device()
        pv, pi = cosine_topk_core(torch.tensor(fused_enc, device="cuda"), small.device_vectors, 10,
                                  row_scales=small.device_scales, valid_n=small.ntotal)
        hybrid = HybridSearcher(BM25Index.load(work / "bm25"))
        want_fused = [[d for d, _ in hybrid.fuse(q, [(small.doc_ids[i], float(s))
                                                     for s, i in zip(sv, si)], k=10)]
                      for q, sv, si in zip(queries[:8], pv.cpu().tolist(), pi.cpu().tolist())]
        mismatched = sum(g != w for g, w in zip(fused_served, want_fused))
        check(mismatched == 0, "the served fusion differs from HybridSearcher's")
        return {"queries": len(want_fused), "mismatched_queries": mismatched}

    def export():
        rep = json.loads(cli_run(["export", "--model", student_dir, "--out", work / "export"],
                                 seconds, "export"))
        s = StudentModel(str(student_dir), device="cpu")
        want_q, _ = quantize_param_tree(jax_params_from_bi_encoder(s.module.state_dict(),
                                                                    s.config))
        back = load_quantized_weights(work / "export" / "weights_int8.npz")
        same = back.keys() == want_q.keys() and all(
            np.array_equal(back[k][kind], want_q[k][kind]) for k in want_q for kind in want_q[k])
        check(rep["validation_min_cosine"] >= 0.99 and same, f"export: {rep}, read back {same}")
        return {"validation_min_cosine": rep["validation_min_cosine"],
                "compression_ratio": rep["compression_ratio"], "read_back_equal": same}

    def compare():
        text = cli_run(["compare", "--kd-model", DEMO / "run_kd/best_model", "--vanilla-model",
                        DEMO / "vanilla", "--teacher-model", DEMO / "teacher", "--data",
                        DEMO_TEST, "--max-samples", "600"], seconds, "compare", expect_rc=1)
        check("**FAILED**" in text, "compare: the gate did not say FAILED")
        rows, want_rows = report_rows(text), eval_record["checkpoints"]["rows"]
        gap = max(abs(rows[m][k] - want_rows[m][k]) for m in want_rows for k in rows[m])
        check(gap <= 1e-3, f"compare: a number {gap} from the eval phase's")
        return {"max_gap_vs_eval": gap}

    def doctor():
        rep = json.loads(cli_run(["doctor", "--index", work / "index"], seconds, "doctor"))
        name = torch.cuda.get_device_name(0)
        check(rep["ok"] and rep["checks"]["cuda_device"].get("name") == name, f"doctor: {rep}")
        return rep["checks"]["cuda_device"]

    def config():
        text = cli_run(["config", "--production-audit"], seconds, "config", expect_rc=1)
        tree, end = json.JSONDecoder().raw_decode(text)
        problems = json.loads(text[end:])["production_problems"]
        check(problems == DEFAULT_AUDIT and tree["service"]["port"] == 8000,
              f"config --production-audit: {problems}")
        return problems

    parts = {"hybrid": hybrid_arm, "export": export, "compare": compare, "doctor": doctor,
             "audit": config}
    with side:
        futures = {name: side.submit(fn) for name, fn in parts.items()}
        for name, fut in futures.items():
            out[name] = fut.result()
    shutil.rmtree(work, ignore_errors=True)
    log(f"[cli] {json.dumps({k: v for k, v in out.items() if k != 'serve'})}")
    return out


def probed_cells(b, q: torch.Tensor) -> torch.Tensor:
    """The cells that clustered_topk probes for ``q``."""
    from sskd_tpu_torch.ops.topk_kernels import topk_stable

    nprobe = min(b.nprobe, b.device_centroids.shape[0])
    return topk_stable(q @ b.device_centroids.T, nprobe)[1]


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke.json"))
    ap.add_argument("--loadgen", help=argparse.SUPPRESS)  # PORT,REQUESTS,CLIENTS,RERANK (child)
    ap.add_argument("--shard-rank", help=argparse.SUPPRESS)  # RANK,PORT,DIR (child of (f))
    args = ap.parse_args(argv)
    if args.loadgen:
        port, n_requests, clients, rerank = (int(v) for v in args.loadgen.split(","))
        print(json.dumps(loadgen(port, n_requests, clients, args.seed, bool(rerank))))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    if args.shard_rank:
        rank, port, work = args.shard_rank.split(",", 2)
        return shard_rank_worker(int(rank), int(port), Path(work))
    from sskd_tpu_torch.utils.logging import setup_logging

    setup_logging(level="WARNING")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {smi}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    record: dict = {"seed": args.seed, "nvidia_smi": smi}
    # the probe library holding the CUDA-core flash the d = 16 route replaced
    # (tools/flash_d16_variants.cuh), compiled beside the product's sources
    flash16_probe = probe_module("probe_flash16").start_build(ROOT / "build" / "chip_smoke_probe")
    record["build"] = phase_build()
    t0 = time.perf_counter()
    topk_rows, main_topk, bf16_topk, int4_topk = phase_topk(gen, N_ROWS)
    flash_rows, main_flash = phase_flash(gen)
    dropattn_rows, main_dfwd, main_dbwd, main_stream, main_dfwd_f32 = phase_dropattn(
        gen, record["build"])
    cell_rows, main_cells, bf16_cells = phase_cells(gen)
    attn64_rows, main_d64 = phase_attention64(gen, record["build"])
    attn16_rows, main_d16 = phase_attention16(gen, record["build"], flash16_probe)
    log(f"[kernels] phase took {time.perf_counter() - t0:.1f} s")
    record["kernel_cases"] = (topk_rows + flash_rows + dropattn_rows + cell_rows + attn64_rows
                              + attn16_rows)
    # the int8 cell_gather at both batches the clustered engine probes with
    record["cell_gather_int8"] = {
        f"B={r['B']}": {n: r[n] for n in ("route", "ms", "kernel_device_ms", "bound_ms",
                                          "distinct_cells")}
        for r in cell_rows if r["kernel"] == "cell_gather" and r["dtype"] == "int8"}
    log(f"[kernels] cell_gather int8: {json.dumps(record['cell_gather_int8'])}")
    t0 = time.perf_counter()
    record["serve"] = phase_serve(args, gen)
    serve_rows = record["serve"].pop("rows")  # for the sharded phase
    log(f"[serve] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["train"] = phase_train(args)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    emb, queries = topical_corpus(args.seed)
    t0 = time.perf_counter()
    record["clustered"] = phase_clustered(args, emb, queries)
    log(f"[clustered] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["sharded"] = phase_sharded(args, serve_rows)
    sharded_reference = record["sharded"].pop("reference")  # for the distributed phase
    del serve_rows
    log(f"[sharded] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["refine"] = phase_refine(args, emb, queries)
    log(f"[refine] phase took {time.perf_counter() - t0:.1f} s")
    del emb, queries
    t0 = time.perf_counter()
    record["teacher"] = phase_teacher(args)
    log(f"[teacher] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["distributed"] = phase_distributed(args, sharded_reference)
    del sharded_reference
    log(f"[distributed] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["eval"] = phase_eval(args, record["build"])
    log(f"[eval] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["pipeline"] = phase_pipeline(args)
    log(f"[pipeline] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record["cli"] = phase_cli(args, record["eval"])
    log(f"[cli] phase took {time.perf_counter() - t0:.1f} s")
    record["seconds"] = time.perf_counter() - t_all
    record["profiler_windows"] = dict(PROFILER)
    log(f"[profiler] kernel_device_ms windows: {json.dumps(PROFILER)}")

    serve_launches = record["serve"]["launches"]
    train_launches = record["train"]["launches"]
    cluster_launches = record["clustered"]["launches"]
    refine_bf16 = {f"{k}.bf16": v for k, v in record["refine"]["bf16_launches"].items()}
    teacher_launches = record["teacher"]["teacher_launches"]
    # the streaming backward's launches on its two paths: the KD run at
    # doc_len 512 (its doc tower) and the teacher at max_len 512
    stream_launches = {
        "dropattn_bwd.stream": record["train"]["doc_len_512"]["stream_launches"],
        "dropattn_bwd.stream.d64": record["teacher"]["train_512"]["stream_launches"]}
    eval_kernels, eval_launches = record["eval"]["kernels"], record["eval"]["launches"]
    tiny_launches = record["pipeline"]["tiny"]["d16_launches"]
    # the f32 student of the demo pipeline: its forwards at d = 32 in f32
    demo_launches = {"dropattn_fwd.f32":
                     record["pipeline"]["demo"]["head_dim_launches"]["dropattn_fwd"][32]}
    kernels = []
    for name, src, replaces, entry, launches in (
        ("binmax", "sskd_tpu_torch/csrc/binmax.cu", "sskd_tpu/ops/topk_pallas.py:82",
         main_topk["binmax"], serve_launches),
        ("bin_gather", "sskd_tpu_torch/csrc/bin_gather.cu", "sskd_tpu/ops/topk_pallas.py:167",
         main_topk["bin_gather"], serve_launches),
        ("flash_attn_fwd", "sskd_tpu_torch/csrc/flash_attn.cu", "sskd_tpu/ops/attention.py:43",
         main_flash, serve_launches),
        ("dropattn_fwd", "sskd_tpu_torch/csrc/dropattn_fwd.cu",
         "sskd_tpu/ops/attention.py:266", main_dfwd, train_launches),
        # its f32 mode at d = 32 (dropattn_fwd_tc_tf32_kernel<32>), with the
        # launches of the demo pipeline's f32 student
        ("dropattn_fwd.f32", "sskd_tpu_torch/csrc/dropattn_fwd.cu",
         "sskd_tpu/ops/attention.py:266", main_dfwd_f32, demo_launches),
        ("dropattn_bwd", "sskd_tpu_torch/csrc/dropattn_bwd.cu",
         "sskd_tpu/ops/attention.py:296", main_dbwd, train_launches),
        # the second kernel of binmax.cu: the approx engine's pass, in place of the binned
        # reduction that XLA fuses for lax.approx_max_k (no Pallas kernel on the TPU side)
        ("binmax_strided", "sskd_tpu_torch/csrc/binmax.cu", "sskd_tpu/ops/topk.py:282",
         main_topk["binmax_strided"], cluster_launches),
        ("cell_gather", "sskd_tpu_torch/csrc/cell_gather.cu",
         "sskd_tpu/ops/topk_cluster.py:248", main_cells["cell_gather"], cluster_launches),
        ("cell_gather_b1", "sskd_tpu_torch/csrc/cell_gather.cu",
         "sskd_tpu/ops/topk_cluster.py:291", main_cells["cell_gather_b1"], cluster_launches),
        # the bf16 routes, each the bf16 branch of its TPU kernel (or of the XLA dot
        # of the approx sweep), with their launches on the refine phase's bf16 indexes
        ("binmax.bf16", "sskd_tpu_torch/csrc/binmax.cu", "sskd_tpu/ops/topk_pallas.py:135",
         bf16_topk["binmax"], refine_bf16),
        ("bin_gather.bf16", "sskd_tpu_torch/csrc/bin_gather.cu",
         "sskd_tpu/ops/topk_pallas.py:205", bf16_topk["bin_gather"], refine_bf16),
        ("binmax_strided.bf16", "sskd_tpu_torch/csrc/binmax.cu", "sskd_tpu/ops/topk.py:267",
         bf16_topk["binmax_strided"], refine_bf16),
        ("cell_gather.bf16", "sskd_tpu_torch/csrc/cell_gather.cu",
         "sskd_tpu/ops/topk_cluster.py:272", bf16_cells["cell_gather"], refine_bf16),
        ("cell_gather_b1.bf16", "sskd_tpu_torch/csrc/cell_gather.cu",
         "sskd_tpu/ops/topk_cluster.py:308", bf16_cells["cell_gather_b1"], refine_bf16),
        # the teacher's head dim 64 (f32 as the teacher computes; flash and the backward on
        # the tensor cores), with the launches of its train steps (dropattn) and of its
        # scoring (flash)
        ("flash_attn_fwd.d64", "sskd_tpu_torch/csrc/flash_attn.cu", "sskd_tpu/ops/attention.py:43",
         main_d64["flash_attn_fwd.d64"], teacher_launches),
        ("dropattn_fwd.d64", "sskd_tpu_torch/csrc/dropattn_fwd.cu",
         "sskd_tpu/ops/attention.py:266", main_d64["dropattn_fwd.d64"], teacher_launches),
        ("dropattn_bwd.d64", "sskd_tpu_torch/csrc/dropattn_bwd.cu",
         "sskd_tpu/ops/attention.py:296", main_d64["dropattn_bwd.d64"], teacher_launches),
        # the backward past a block's shared memory, streaming the head: bf16 at
        # [256, 12, 512, 32] (the KD doc tower at doc_len 512) and f32 at
        # [32, 16, 512, 64] (the teacher at max_len 512)
        ("dropattn_bwd.stream", "sskd_tpu_torch/csrc/dropattn_bwd.cu",
         "sskd_tpu/ops/attention.py:296", main_stream, stream_launches),
        ("dropattn_bwd.stream.d64", "sskd_tpu_torch/csrc/dropattn_bwd.cu",
         "sskd_tpu/ops/attention.py:296", main_d64["dropattn_bwd.stream.d64"], stream_launches),
        # the f32 routes the evaluation at full width takes: binmax and bin_gather over
        # its 8,192 f32 rows for 1,000 queries, flash at d = 32 in its f32 encode
        ("binmax.f32", "sskd_tpu_torch/csrc/binmax.cu", "sskd_tpu/ops/topk_pallas.py:82",
         eval_kernels["binmax.f32"], eval_launches),
        ("bin_gather.f32", "sskd_tpu_torch/csrc/bin_gather.cu",
         "sskd_tpu/ops/topk_pallas.py:167", eval_kernels["bin_gather.f32"], eval_launches),
        ("flash_attn_fwd.f32", "sskd_tpu_torch/csrc/flash_attn.cu",
         "sskd_tpu/ops/attention.py:43", eval_kernels["flash_attn_fwd.f32"], eval_launches),
        # head dim 16, the pipeline's --tiny models: the bf16 student's encode
        # at L = 512 (flash), its KD run and the f32 teacher's train steps
        # (both forwards on the tensor cores; the f32 backward streaming)
        ("flash_attn_fwd.d16", "sskd_tpu_torch/csrc/flash_attn.cu",
         "sskd_tpu/ops/attention.py:43", main_d16["flash_attn_fwd.d16"], tiny_launches),
        ("dropattn_fwd.d16", "sskd_tpu_torch/csrc/dropattn_fwd.cu",
         "sskd_tpu/ops/attention.py:266", main_d16["dropattn_fwd.d16"], tiny_launches),
        ("dropattn_bwd.d16", "sskd_tpu_torch/csrc/dropattn_bwd.cu",
         "sskd_tpu/ops/attention.py:296", main_d16["dropattn_bwd.d16"], tiny_launches),
        ("dropattn_fwd.d16.f32", "sskd_tpu_torch/csrc/dropattn_fwd.cu",
         "sskd_tpu/ops/attention.py:266", main_d16["dropattn_fwd.d16.f32"], tiny_launches),
        ("dropattn_bwd.d16.f32", "sskd_tpu_torch/csrc/dropattn_bwd.cu",
         "sskd_tpu/ops/attention.py:296", main_d16["dropattn_bwd.d16.f32"], tiny_launches),
    ):
        check(launches[name] > 0, f"kernel {name} was launched no time on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": entry["library_ms"],
        })
        if name in int4_topk:  # its packed int4 mode on the tensor cores, B = 16
            kernels[-1]["int4"] = {n: int4_topk[name][n]
                                   for n in ("ms", "kernel_device_ms", "bound_ms")}
        if name == "bin_gather":  # its bf16 rows on the tensor cores, B = 16
            kernels[-1]["bf16"] = {n: bf16_topk[name][n]
                                   for n in ("ms", "kernel_device_ms", "bound_ms")}
        if name == "bin_gather.f32":  # an f32 index's /search: B = 16, kb = 10, 1M rows
            kernels[-1]["kernel"] = "bin_gather_f32_tc_kernel"
            kernels[-1]["search_b16"] = {n: main_topk["bin_gather.f32.search"][n] for n in (
                "ms", "kernel_device_ms", "kernel_device_ms_cold_l2", "bound_ms",
                "cuda_core_kernel_device_ms")}
            kernels[-1]["cuda_core_kernel_device_ms"] = entry["cuda_core_kernel_device_ms"]
        if name == "flash_attn_fwd.d16":  # the kernel the route took before, the same call
            kernels[-1]["kernel"] = "flash_fwd_tc2_kernel<16, 2, 4>"
            kernels[-1].update({n: entry[n] for n in (
                "kernel_device_ms", "cuda_core_kernel_device_ms")})
        if name == "dropattn_bwd.d16":  # the kernel the route took before, the same call
            kernels[-1]["kernel"] = "dropattn_bwd_tc_3pass_kernel"
            kernels[-1].update({n: entry[n] for n in (
                "buffer_kernel_device_ms", "three_pass_device_ms", "stream_device_ms")})
    # the launches of the sharded path (the sharded phase), beside each kernel's own
    for entry in kernels:
        if entry["name"] in SHARDED_KERNELS:
            entry["sharded_launches"] = record["sharded"]["launches"][entry["name"]]
        # and of the distributed phase: data-parallel KD (the dropout pair) and
        # the teacher's two tensor-parallel slices (flash at d = 64)
        if entry["name"] in record["distributed"]["launches"]:
            entry["distributed_launches"] = record["distributed"]["launches"][entry["name"]]
        # and of the index axis over the process group, (e) and each rank of (f)
        if entry["name"] in record["distributed"]["index_axis_launches"]:
            entry["index_axis_launches"] = record["distributed"]["index_axis_launches"][
                entry["name"]]
    record["kernels"] = kernels
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    log(f"[done] {record['seconds']:.1f} s; record in {out}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
