#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sskd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal when it fails:

1. build   — compile every csrc/*.cu with nvcc (one process per source, all
             at once) and print each kernel's registers, shared memory and
             spills;
2. kernels — each kernel against its plain torch version on the card at the
             shapes of the main path (binmax / exact engine: f32, int8 and
             int4 at 1M x 384, B in {1, 16, 256}, k in {10, 100};
             flash_attn_fwd: [256, 12, L, 32] bf16, L in {128, 256, 512},
             each element within its rounding bound, and f32 at L = 512
             within 1e-5): error, time per launch (CUDA events), the bound and a library
             yardstick that the port never calls;
3. serve   — the main path at full e5-small-v2 width (12 layers, hidden 384,
             bf16, seeded random weights): encode 8,192 passages of at least
             510 tokens (L = 512, batch 256), fill an int8 exact index to
             1,000,000 rows with seeded unit vectors, save and load it, serve
             it with create_app on 127.0.0.1, send single and concurrent
             /search requests, and check every response against the plain
             engine on the same query embeddings; every kernel must have been
             launched by this phase; then recall@10 of the int8 exact search
             against exact f32 search over the original vectors (gate 0.97).

The line before the last is {"kernels": [...]}, the one before it the card's
name and power limit, the last {"ok": true, "device": {...}}. The full
record goes to chiprun_out/chip_smoke.json. Exits non-zero without a result
when CUDA is not available or a phase fails.
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import math
import re
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
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}  # dense, per second
N_DOCS = 8192  # passages encoded at L = 512
N_ROWS = 1_000_000  # rows of the served index (and of the kernel cases)
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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max relative error over the entries that are not the -inf sentinel."""
    got, want = got.float(), want.float()
    live = want.abs() < 1e30
    return ((got - want).abs()[live] / want.abs()[live].clamp(min=1e-6)).max().item()


def bound_ms(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
            if m and kernel:
                summary.setdefault(name, {})[kernel] = {
                    "registers": int(m.group(1)), "smem_bytes": int(m.group(2))
                }
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


def phase_topk(gen, n_rows: int, dim: int = 384) -> tuple[list, dict, dict]:
    from sskd_tpu_torch.ops import topk_kernels as tk
    from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4
    from sskd_tpu_torch.ops.topk import cosine_topk_core

    x = unit_rows(n_rows, dim, gen)
    valid_n = n_rows
    rows, main_binmax, main_gather = [], None, None
    for dtype in ("int8", "f32", "int4"):
        if dtype == "f32":
            corpus, scales = x, None
        else:
            corpus, scales = (quantize_rows if dtype == "int8" else quantize_rows_int4)(x)
        row_bytes = corpus.shape[1] * corpus.element_size()
        op_kind = "f32" if dtype == "f32" else "int8"
        for B in (1, 16, 256):
            q = unit_rows(B, dim, gen)
            q_in, q_scale = tk.quantize_queries(q, corpus)
            got = tk.binmax(q_in, corpus, scales, valid_n)
            want = tk.binmax_plain(q_in, corpus, scales, valid_n)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 0.0 if dtype != "f32" else 1e-5
            check(err <= tol, f"binmax {dtype} B={B}: max abs err {err} > {tol}")
            n_bins = got.shape[0]
            ms = time_ms(lambda: tk.binmax(q_in, corpus, scales, valid_n), 20)
            plain_ms = time_ms(lambda: tk.binmax_plain(q_in, corpus, scales, valid_n), 3, 1)
            library_ms = None
            if dtype == "f32":
                def lib_fn():
                    return (corpus @ q_in.T)[: (n_rows // 128) * 128].view(-1, 128, B).amax(1)
                library_ms = time_ms(lib_fn, 5)
            elif dtype == "int8" and B % 8 == 0:
                def lib_fn():
                    s = torch._int_mm(corpus, q_in.T).float() * scales[:, None]
                    return s[: (n_rows // 128) * 128].view(-1, 128, B).amax(1)
                library_ms = time_ms(lib_fn, 5)
            b_ms, b_by = bound_ms(
                n_rows * row_bytes + n_rows * 4 * (scales is not None)
                + q_in.numel() * q_in.element_size() + n_bins * B * 4,
                2.0 * B * n_rows * dim, op_kind,
            )
            entry = {
                "kernel": "binmax", "dtype": dtype, "B": B, "N": n_rows, "D": dim,
                "max_abs_err": err, "max_rel_err": rel_err(got, want), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
            }
            rows.append(entry)
            log(f"[kernels] {json.dumps(entry)}")
            if dtype == "int8" and B == 16:
                main_binmax = entry
            for k in (10, 100):
                kb = min(k, n_bins)
                _, bins = tk.topk_stable(want.T, kb)
                bins = bins.to(torch.int32).contiguous()
                g_got = tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
                g_want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n)
                torch.cuda.synchronize()
                g_err = (g_got - g_want).abs().max().item()
                g_tol = 0.0 if dtype != "f32" else 1e-5
                check(g_err <= g_tol, f"bin_gather {dtype} B={B} k={k}: err {g_err} > {g_tol}")
                g_ms = time_ms(
                    lambda: tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n), 20
                )
                g_plain = time_ms(
                    lambda: tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n),
                    2, 1,
                )
                # bytes: each distinct bin's rows once (queries share bins)
                cand = B * kb * 128
                rows_read = torch.unique(bins).numel() * 128
                gb_ms, gb_by = bound_ms(
                    rows_read * (row_bytes + 4 * (scales is not None)) + cand * 4
                    + bins.numel() * 4 + q_in.numel() * q_in.element_size(),
                    2.0 * cand * dim, op_kind,
                )
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
                    "max_abs_err": g_err, "max_rel_err": rel_err(g_got, g_want),
                    "ms": g_ms, "plain_ms": g_plain, "bound_ms": gb_ms,
                    "bound_by": gb_by, "library_ms": None,
                    "engine_ms": e_ms, "plain_engine_ms": e_plain,
                }
                rows.append(g_entry)
                log(f"[kernels] {json.dumps(g_entry)}")
                if dtype == "int8" and B == 16 and k == 10:
                    main_gather = g_entry
        del corpus, scales
    return rows, main_binmax, main_gather


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
        got = ta.flash_attention(q, k, v, mask)
        want = ta.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # bf16: per element, the rounding of p and of the output on each side
        # (ta.flash_error_bound derives it)
        slack = (diff / ta.flash_error_bound(q, k, v, mask, got, want)).max().item()
        check(slack <= 1.0, f"flash_attn_fwd L={L}: max abs err {err} is {slack:.3f} "
              "of its bound")
        f32_err = None
        if L == 512:
            # the f32 instantiation of the same kernel code rounds nothing, so
            # it holds the scale, the masking and every tile to summation order
            qf, kf, vf = q.float(), k.float(), v.float()
            f32_err = (ta.flash_attention(qf, kf, vf, mask)
                       - ta.flash_attention_plain(qf, kf, vf, mask)).abs().max().item()
            check(f32_err <= 1e-5, f"flash_attn_fwd f32 L={L}: max abs err {f32_err} > 1e-5")
            del qf, kf, vf
        ms = time_ms(lambda: ta.flash_attention(q, k, v, mask), 10)
        plain_ms = time_ms(lambda: ta.flash_attention_plain(q, k, v, mask), 3, 1)
        keep = mask[:, None, None, :].bool()
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 10
        )
        b_ms, b_by = bound_ms(4 * B * h * L * d * 2 + B * L * 4, 4.0 * B * h * L * L * d, "bf16")
        entry = {
            "kernel": "flash_attn_fwd", "dtype": "bf16", "shape": [B, h, L, d],
            "max_abs_err": err, "max_rel_err": rel_err(got, want), "err_over_bound": slack,
            "f32_max_abs_err": f32_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
        }
        rows.append(entry)
        log(f"[kernels] {json.dumps(entry)}")
        if L == 512:
            main = entry
    return rows, main


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


def post(port: int, path: str, body: dict, timeout: float = 300.0) -> tuple[int, dict, float]:
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body), {"content-type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def get(port: int, path: str) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def loadgen(port: int, n_requests: int, clients: int, seed: int) -> dict:
    """Closed-loop load: ``clients`` threads, each sending its share of
    ``n_requests`` /search requests one after another. Runs in its own
    process (``--loadgen``), so the clients do not share the server's
    interpreter lock."""
    rng = np.random.default_rng(seed)
    queries = [" ".join(rng.choice(WORDS, 6)) for _ in range(n_requests)]
    per_client = [queries[i::clients] for i in range(clients)]

    def client(qs):
        out = []
        for q in qs:
            try:
                status, _, ms = post(port, "/search", {"query": q, "k": 10})
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
        "queries_per_s": len(done) / wall, "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)), "max_ms": lat[-1],
    }


def run_load(port: int, n_requests: int, clients: int, seed: int) -> dict:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         "--loadgen", f"{port},{n_requests},{clients}"],
        capture_output=True, text=True, timeout=900, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


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
        busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
        parts["device_busy_share"] = busy_us / wall_us if busy_us > 0 else None
        out[f"B={n}"] = parts
        log(f"[serve] breakdown B={n}: {json.dumps(parts)}")
    return out


def phase_serve(args, gen) -> dict:
    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts
    from sskd_tpu_torch.ops.topk import cosine_topk_core
    from sskd_tpu_torch.serve.app import create_app
    from sskd_tpu_torch.serve.fused import K_BUCKETS
    from sskd_tpu_torch.serve.http import Server

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
        log(f"[serve] app ready on 127.0.0.1:{port} after {startup_s:.1f} s "
            "(checkpoint + index load + warmup)")

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
    finally:
        if thread.is_alive():
            asyncio.run_coroutine_threadsafe(server.shutdown(drain_timeout=5.0), loop).result(60)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(60)
    check(not thread.is_alive(), "server thread did not stop")
    check("error" not in served, f"server failed: {served.get('error')!r}")
    loop.close()
    # the main path ends here: what follows (breakdown, checks) launches the
    # kernels outside it
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] launches on the main path: {counts}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
    }


def _real_rows(recorded, student) -> list[int]:
    """Rows of each recorded batch that hold a query (not prefix-only padding)."""
    pad_len = len(student.tokenizer.tokenize(student.query_prefix)) + 2
    return [int((ids_[:, pad_len:pad_len + 1] != student.tokenizer.pad_id).sum())
            for ids_, _ in recorded]


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke.json"))
    ap.add_argument("--loadgen", help=argparse.SUPPRESS)  # PORT,REQUESTS,CLIENTS (child)
    args = ap.parse_args(argv)
    if args.loadgen:
        port, n_requests, clients = (int(v) for v in args.loadgen.split(","))
        print(json.dumps(loadgen(port, n_requests, clients, args.seed)))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
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
    record["build"] = phase_build()
    t0 = time.perf_counter()
    topk_rows, main_binmax, main_gather = phase_topk(gen, N_ROWS)
    flash_rows, main_flash = phase_flash(gen)
    log(f"[kernels] phase took {time.perf_counter() - t0:.1f} s")
    record["kernel_cases"] = topk_rows + flash_rows
    t0 = time.perf_counter()
    record["serve"] = phase_serve(args, gen)
    log(f"[serve] phase took {time.perf_counter() - t0:.1f} s")
    record["seconds"] = time.perf_counter() - t_all

    launches = record["serve"]["launches"]
    kernels = []
    for name, src, replaces, entry in (
        ("binmax", "sskd_tpu_torch/csrc/binmax.cu", "sskd_tpu/ops/topk_pallas.py:82",
         main_binmax),
        ("bin_gather", "sskd_tpu_torch/csrc/bin_gather.cu", "sskd_tpu/ops/topk_pallas.py:167",
         main_gather),
        ("flash_attn_fwd", "sskd_tpu_torch/csrc/flash_attn.cu", "sskd_tpu/ops/attention.py:43",
         main_flash),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": entry["library_ms"],
        })
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
