"""The rest of the port's serving against the JAX package's: the caches,
the rate limiter and API-key auth (their 401 / 429 answers), hybrid BM25
fusion over a BM25 index the JAX package built, the OpenAPI spec and /docs
page (equal strings), and the two apps side by side through their in-process
clients on one tiny int8 index with the cache, MaxSim aggregation and the
hybrid arm on (equal ids, cached repeats, /index/load, /cache/flush, the
same span names); then the port's supervisor with two CPU workers."""

import itertools
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from sskd_tpu.config import Settings as JSettings
from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu.mining.bm25 import BM25Index as JBM25
from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.serve import app as j_app_module
from sskd_tpu.serve import cache as j_cache
from sskd_tpu.serve import hybrid as j_hybrid
from sskd_tpu.serve import http as j_http
from sskd_tpu.serve import middleware as j_mw
from sskd_tpu.serve.openapi import build_openapi as j_build_openapi
from sskd_tpu.serve.openapi import render_docs_html as j_render_docs
from sskd_tpu.utils.tracing import TRACER as J_TRACER
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.mining.bm25 import BM25Index
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.serve import app as app_module
from sskd_tpu_torch.serve import cache, hybrid, http, middleware
from sskd_tpu_torch.serve.openapi import build_openapi, render_docs_html
from sskd_tpu_torch.tokenization import WordPieceTokenizer
from sskd_tpu_torch.utils.tracing import TRACER

ROOT = Path(__file__).resolve().parent.parent
TOPICS = ["river bank water", "money bank loan", "python code snake", "jazz music night",
          "mountain snow climb", "coffee bean roast", "solar panel energy", "chess opening move"]
# two chunks a document (ids "doc{i}"), so that MaxSim aggregation has work to do
CHUNKS = [f"{TOPICS[i % 8]} part {j} detail {i * 3 % 7}" for i in range(24) for j in range(2)]
CHUNK_DOCS = [f"doc{i}" for i in range(24) for _ in range(2)]
DOC_TEXTS = [" ".join(CHUNKS[2 * i : 2 * i + 2]) for i in range(24)]
QUERIES = ["bank water", "python snake", "music at night", "roast coffee beans", "energy"]


# ---------------------------------------------------------------------------
# caches, rate limit, auth
# ---------------------------------------------------------------------------


def test_ttl_cache_under_an_injected_clock():
    now = [0.0]
    caches = [mod.TTLCache(max_size=3, ttl_seconds=10.0, clock=lambda: now[0])
              for mod in (cache, j_cache)]
    ops = [("put", "a", 1), ("put", "b", 2), ("get", "a"), ("tick", 5.0), ("put", "c", 3),
           ("put", "d", 4), ("get", "b"), ("get", "a"), ("tick", 5.5), ("get", "a"),
           ("get", "c"), ("put", "c", 5), ("tick", 9.0), ("get", "c"), ("get", "d")]
    logs = [[], []]
    for op in ops:
        if op[0] == "tick":
            now[0] += op[1]
            continue
        for c, log in zip(caches, logs):
            log.append(c.put(op[1], op[2]) if op[0] == "put" else c.get(op[1]))
    assert logs[0] == logs[1] and logs[0][-2:] == [5, None]
    assert caches[0].stats() == caches[1].stats() and len(caches[0]) == len(caches[1])
    assert caches[0].clear() == caches[1].clear()


@pytest.mark.parametrize("query", ["What  is BANK?", "x", "ünïcode  Straße"])
def test_cache_keys_equal_jax(query):
    assert cache.normalize_query(query) == j_cache.normalize_query(query)
    for args in ((5, False, 50), (10, True, 20)):
        assert cache.result_cache_key(query, *args) == j_cache.result_cache_key(query, *args)
    for norm in (True, False):
        assert cache.embedding_cache_key(query, norm) == j_cache.embedding_cache_key(query, norm)


def _frozen_limiter_clock(monkeypatch, now: list) -> None:
    """Both packages' rate limiters read ``now[0]`` for time.monotonic (the
    rest of the process, the event loop too, keeps the real clock)."""
    clock = types.SimpleNamespace(monotonic=lambda: now[0], perf_counter=time.perf_counter)
    for mod in (middleware, j_mw):
        monkeypatch.setattr(mod, "time", clock)


def test_rate_limiter_decisions_equal_jax(monkeypatch):
    now = [1000.0]
    _frozen_limiter_clock(monkeypatch, now)
    limiters = (middleware.RateLimiter(60, 3), j_mw.RateLimiter(60, 3))
    # (seconds since the last request, path, client, forwarded-for)
    seq = [(0, "/search", "a", ""), (0.1, "/search", "a", ""), (0.1, "/search", "a", ""),
           (0.1, "/search", "a", ""), (0.2, "/health", "a", ""), (0.5, "/search", "b", ""),
           (0.4, "/search", "a", ""), (0, "/search", "c", "a, proxy"), (2.5, "/search", "a", ""),
           (400, "/encode", "a", ""), (0, "/encode", "a", ""), (700, "/search", "b", "")]
    got = [[], []]
    for dt, path, client, fwd in seq:
        now[0] += dt
        headers = {"X-Forwarded-For": fwd} if fwd else {}
        for lim, mod, out in zip(limiters, (http, j_http), got):
            out.append(lim.check(mod.Request("POST", path, headers=headers, client=client)))
    assert got[0] == got[1]
    assert [ok for ok, _ in got[0]].count(False) >= 2
    assert sorted(limiters[0]._buckets) == sorted(limiters[1]._buckets)


def _guarded_client(http_mod, mw_mod, salt):
    app = http_mod.App()

    @app.post("/search")
    async def search(request):
        return http_mod.Response({"ok": True})

    app.add_middleware(mw_mod.RateLimiter(60, 2).middleware())
    app.add_middleware(mw_mod.APIKeyAuth(api_keys=["sk_live_k"], salt=salt,
                                         header="X-Key").middleware())
    return http_mod.TestClient(app)


@pytest.mark.parametrize("salt", ["", "s"])
def test_401_and_429_answers_equal_jax(monkeypatch, salt):
    _frozen_limiter_clock(monkeypatch, [1000.0])  # no token refills between the stacks
    clients = [_guarded_client(http, middleware, salt), _guarded_client(j_http, j_mw, salt)]
    key = {"X-Key": "sk_live_k"}
    seq = [({}, b"{}"), ({"X-Key": "wrong"}, b"{}"), (key, b"{}"), (key, b"{}"), (key, b"{}"),
           ({}, b"{}"), ({"X-Key": "sk_live_k"}, b"{}")]
    answers = [[], []]
    for headers, body in seq:
        for tc, out in zip(clients, answers):
            r = tc.post("/search", headers=headers, body=body)
            out.append((r.status, r.json(), r.headers))
    # a request without a key is answered 401 before it spends a token
    assert [a[0] for a in answers[0]] == [401, 401, 200, 200, 429, 401, 429]
    assert answers[0] == answers[1]
    for tc in clients:
        tc.close()


# ---------------------------------------------------------------------------
# hybrid fusion
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bm25_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("bm25")
    JBM25().build(DOC_TEXTS, [f"doc{i}" for i in range(24)]).save(out)
    return out


def test_fusion_and_expansion_equal_jax(bm25_dir):
    tb, jb = BM25Index.load(bm25_dir), JBM25.load(bm25_dir)
    rng = np.random.default_rng(0)
    ids = list(jb.doc_ids)
    arms = [[(d, float(s)) for d, s in zip(rng.permutation(ids)[:12], np.sort(rng.random(12))[::-1])]
            for _ in range(2)]
    arms.append([(ids[0], 1.0), (ids[1], 1.0)])  # a flat arm: min-max gives all ones
    for w in ([0.7, 0.3, 0.5], [0.5, 0.5, 0.0]):
        for k in (3, 10):
            assert hybrid.rrf_fuse(arms, w, rrf_k=60, k=k) == j_hybrid.rrf_fuse(arms, w, 60, k)
            assert hybrid.linear_fuse(arms, w, k=k) == j_hybrid.linear_fuse(arms, w, k=k)
    with pytest.raises(ValueError):
        hybrid.rrf_fuse(arms, [1.0])
    for q in QUERIES + ["zzz unknown"]:
        assert hybrid.expand_query(q, tb, 3, 5) == j_hybrid.expand_query(q, jb, 3, 5)
    for method, expansion in itertools.product(("rrf", "linear"), (False, True)):
        th = hybrid.HybridSearcher(tb, fusion_method=method, query_expansion=expansion)
        jh = j_hybrid.HybridSearcher(jb, fusion_method=method, query_expansion=expansion)
        for q in QUERIES:
            dense = [(ids[i], 1.0 - 0.05 * r) for r, i in enumerate(rng.permutation(len(ids))[:8])]
            assert th.fuse(q, dense, k=6) == jh.fuse(q, dense, k=6)


# ---------------------------------------------------------------------------
# OpenAPI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metrics,flush,auth", list(itertools.product(
    [None, "/metrics", "/prom"], [False, True], [False, True])))
def test_openapi_and_docs_equal_jax(metrics, flush, auth):
    kw = dict(metrics_path=metrics, cache_flush=flush, auth_enabled=auth)
    spec = build_openapi("0.1.0", **kw)
    want = j_build_openapi("0.1.0", **kw)
    assert json.dumps(spec) == json.dumps(want)
    assert render_docs_html(spec) == j_render_docs(want)


# ---------------------------------------------------------------------------
# the two apps side by side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory, bm25_dir):
    tok = WordPieceTokenizer.build_from_corpus(CHUNKS + QUERIES + ["query passage"],
                                               vocab_size=512)
    from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer

    js = JStudent("tiny-extras", config=JConfig.tiny(vocab_size=tok.vocab_size),
                  tokenizer=JTokenizer(tok.vocab))
    ts = StudentModel("tiny-extras", device="cpu", config=BertConfig.tiny(vocab_size=tok.vocab_size),
                      tokenizer=tok, params=jax.tree_util.tree_map(np.asarray, js.params))
    root = tmp_path_factory.mktemp("extras")
    emb = js.encode_documents(CHUNKS)
    # each row is a chunk recorded under its document's id, the BM25 arm's id
    b = JBuilder(embedding_dim=64, dtype="int8", index_type="exact")
    b.build_from_arrays(emb, CHUNK_DOCS, texts=CHUNKS)
    b.save(root / "idx")
    b2 = JBuilder(embedding_dim=64, dtype="int8", index_type="exact")
    b2.build_from_arrays(emb[:20], CHUNK_DOCS[:20], texts=CHUNKS[:20])
    b2.save(root / "idx2")
    return js, ts, root


def _apps(monkeypatch, served, bm25_dir, tree):
    js, ts, root = served
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **k: ts)
    monkeypatch.setattr(j_app_module, "StudentModel", lambda *a, **k: js)
    TRACER.clear()
    J_TRACER.clear()
    tc = http.TestClient(app_module.create_app(Settings.from_dict(tree), device="cpu",
                                               preload_index_dir=str(root / "idx")))
    jc = j_http.TestClient(j_app_module.create_app(JSettings.model_validate(tree),
                                                   preload_index_dir=str(root / "idx")))
    return tc, jc


@pytest.mark.parametrize("fusion", ["rrf", "linear"])
def test_apps_answer_alike(monkeypatch, served, bm25_dir, fusion):
    tree = {
        "service": {"micro_batch_max_size": 1},
        "cache": {"enabled": True},
        "search": {"maxsim_aggregation": True,
                   "hybrid": {"enabled": True, "bm25_index_path": str(bm25_dir),
                              "fusion_method": fusion, "query_expansion": fusion == "linear"}},
    }
    tc, jc = _apps(monkeypatch, served, bm25_dir, tree)
    try:
        for q in QUERIES:
            got = tc.post("/search", json_body={"query": q, "k": 5})
            want = jc.post("/search", json_body={"query": q, "k": 5})
            assert got.status == want.status == 200
            g, w = got.json(), want.json()
            assert [r["doc_id"] for r in g["results"]] == [r["doc_id"] for r in w["results"]]
            assert [r["text"] for r in g["results"]] == [r["text"] for r in w["results"]]
            # RRF scores depend on ranks only; linear fusion min-max normalizes
            # the dense scores (within 1e-6 of each other) over their range,
            # which scales the difference up to a few 1e-6
            np.testing.assert_allclose([r["score"] for r in g["results"]],
                                       [r["score"] for r in w["results"]], atol=1e-5)
            assert g["hybrid"] is w["hybrid"] is True and g["cached"] is w["cached"] is False
            for c in (tc, jc):  # a repeat, in other case and spacing
                again = c.post("/search", json_body={"query": q.upper() + "  ", "k": 5}).json()
                assert again["cached"] is True
                assert again["results"] == (g if c is tc else w)["results"]
        for c in (tc, jc):
            enc = c.post("/encode", json_body={"texts": QUERIES[:2]}).json()
            enc2 = c.post("/encode", json_body={"texts": QUERIES[1:3]}).json()
            assert enc2["embeddings"][0] == enc["embeddings"][1]
        np.testing.assert_allclose(enc2["embeddings"], tc.post(
            "/encode", json_body={"texts": QUERIES[1:3]}).json()["embeddings"], atol=1e-5)
        for c in (tc, jc):
            assert c.get("/").json()["endpoints"] == jc.get("/").json()["endpoints"]
            assert c.get("/openapi.json").json() == jc.get("/openapi.json").json()
            assert c.get("/docs").status == 200
        metrics = tc.get("/metrics").body.decode()
        assert 'semantic_kd_cache_hits_total{cache="result"} 5.0' in metrics
        assert 'semantic_kd_cache_hits_total{cache="embedding"} 3.0' in metrics
        # the swap: the result cache is flushed, the embedding cache kept
        idx2 = str(served[2] / "idx2")
        got = tc.post("/index/load", json_body={"index_dir": idx2}).json()
        assert got == jc.post("/index/load", json_body={"index_dir": idx2}).json()
        assert got["index_size"] == 20 and tc.get("/health").json()["index_size"] == 20
        r = tc.post("/search", json_body={"query": QUERIES[0], "k": 5}).json()
        w = jc.post("/search", json_body={"query": QUERIES[0], "k": 5}).json()
        assert r["cached"] is False and [x["doc_id"] for x in r["results"]] == \
            [x["doc_id"] for x in w["results"]]
        assert tc.post("/index/load", json_body={"index_dir": "/nonexistent"}).status == 400
        flushed = tc.post("/cache/flush").json()
        assert flushed == jc.post("/cache/flush").json() == \
            {"flushed": {"result": 1, "embedding": 3}}
        names = sorted({s.name for s in TRACER.recent(limit=10_000)})
        assert names == sorted({s.name for s in J_TRACER.recent(limit=10_000)})
        assert names == ["index_search", "load_index", "load_model"]
    finally:
        tc.close()
        jc.close()


def test_app_with_auth_rate_limit_and_batcher(monkeypatch, served, bm25_dir):
    _frozen_limiter_clock(monkeypatch, [1000.0])  # the first search's compile refills nothing
    tree = {"auth": {"enabled": True, "api_keys": ["sk_live_t"]},
            "rate_limit": {"enabled": True, "burst": 3},
            "service": {"micro_batch_max_size": 4}}
    tc, jc = _apps(monkeypatch, served, bm25_dir, tree)
    try:
        for c in (tc, jc):
            assert c.post("/search", json_body={"query": "bank"}).status == 401
            assert c.get("/health").status == 200
            # /openapi.json needs no key but spends a token
            assert c.get("/openapi.json").json()["security"] == [{"ApiKeyAuth": []}]
            statuses = [c.post("/search", json_body={"query": q},
                               headers={"X-API-Key": "sk_live_t"}).status for q in QUERIES[:4]]
            assert statuses == [200, 200, 429, 429]
        metrics = tc.get("/metrics", headers={"X-API-Key": "sk_live_t"}).body.decode()
        assert "semantic_kd_rate_limit_hits_total 2.0" in metrics  # /metrics spends no token
        assert "/cache/flush" not in tc.get("/").json()["endpoints"]
    finally:
        tc.close()
        jc.close()


def test_jax_profiler_port_is_refused():
    with pytest.raises(ConfigError, match="jax_profiler_port"):
        app_module.create_app(Settings.from_dict({"monitoring": {"jax_profiler_port": 9999}}),
                              device="cpu")


# ---------------------------------------------------------------------------
# the supervisor's workers
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_supervisor_workers_serve_and_drain(served, tmp_path):
    """Two workers start, both bind the port (each logs that it serves),
    /health answers; SIGTERM to the supervisor drains both and it exits 0.
    A worker that the supervisor's repeated SIGTERM reaches while the
    interpreter winds down ends by that signal, which the supervisor counts
    as clean at shutdown, as the JAX package's does."""
    _, ts, _ = served
    ts.save(tmp_path / "student")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "SSKD_LOG_SYNC": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sskd_tpu_torch.cli.main", "serve", "--platform", "cpu",
         "--workers", "2", "--host", "127.0.0.1", "--port", str(port),
         "--model", str(tmp_path / "student")],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 90
        healthy = False
        while time.monotonic() < deadline and not (
                healthy and sum("serving on" in ln for ln in lines) == 2):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    healthy = json.loads(r.read())["status"] == "healthy"
            except OSError:
                pass
            time.sleep(0.3)
        assert healthy and sum("serving on" in ln for ln in lines) == 2, "".join(lines)[-2000:]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, "".join(lines)[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(10)
    err = "".join(lines)
    assert sum("worker" in ln and "started" in ln for ln in lines) == 2, err[-2000:]
    codes = re.search(r"worker codes \{0: (-?\d+), 1: (-?\d+)\}", err)
    assert codes and {int(c) for c in codes.groups()} <= {0, -signal.SIGTERM}, err[-2000:]
