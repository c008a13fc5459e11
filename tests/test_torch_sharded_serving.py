"""Sharded serving: with mesh.index_parallel > 1 the port's app lifts a
loaded index onto a CPU mesh and serves /search through the sharded fused
searcher, with the doc ids of the JAX package's sharded app (8 virtual CPU
devices, the same carried-over tiny weights) and of the unsharded index;
``semantic-kd-torch serve --shards 2 --cpu-devices 2`` does the same in a
process of its own. (The one-device CUDA mesh against the single-device
engines is a ``gpu`` test in tests/test_torch_kernels_gpu.py, a file that
imports no JAX.)"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

import sskd_tpu.serve.app as japp_module
from sskd_tpu.config import Settings as JSettings
from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.serve.http import TestClient as JTestClient
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.parallel import mesh as mesh_module
from sskd_tpu_torch.serve import app as app_module
from sskd_tpu_torch.serve.fused import FusedSearcher, ShardedFusedSearcher
from sskd_tpu_torch.serve.http import TestClient
from sskd_tpu_torch.tokenization import WordPieceTokenizer

ROOT = Path(__file__).resolve().parent.parent
DOCS = [f"document about topic {i} with words {i * 7 % 13}" for i in range(300)]
QUERIES = ["find topic 3", "words 5 topic", "what about topic 17", "document", "topic 250"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX tiny student and the port's over the same weights, and an
    int8 exact index of their 300 docs saved by the JAX package."""
    tok = JTokenizer.build_from_corpus(DOCS + ["query passage what find about"], vocab_size=512)
    js = JStudent("tiny-shard", config=JConfig.tiny(vocab_size=tok.vocab_size), tokenizer=tok)
    ts = StudentModel(
        "tiny-shard", device="cpu", config=BertConfig.tiny(vocab_size=tok.vocab_size),
        tokenizer=WordPieceTokenizer(tok.vocab),
        params=jax.tree_util.tree_map(np.asarray, js.params),
    )
    jb = JBuilder(embedding_dim=64, dtype="int8")
    jb.build_from_arrays(js.encode_documents(DOCS), [f"d{i}" for i in range(len(DOCS))],
                         texts=DOCS)
    idx_dir = tmp_path_factory.mktemp("idx")
    jb.save(idx_dir)
    return js, ts, str(idx_dir)


@pytest.fixture
def cpu_entries(monkeypatch):
    """The CPU entries a mesh may take, as --cpu-devices 8 would set them."""
    monkeypatch.setattr(mesh_module, "_cpu_devices", 8)


def _ids(body):
    return [r["doc_id"] for r in body["results"]]


def _unsharded_ids(ts, idx_dir, k):
    b = IndexBuilder(device="cpu").load(idx_dir)
    _, idx = FusedSearcher(ts, b).search_texts(QUERIES, k=k)
    return [[b.doc_ids[i] for i in row] for row in idx]


@pytest.mark.parametrize("k", [3, 10])
def test_index_load_shards_and_serves_the_jax_ids(monkeypatch, pair, cpu_entries, k):
    js, ts, idx_dir = pair
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **kw: ts)
    monkeypatch.setattr(japp_module, "StudentModel", lambda *a, **kw: js)
    tc = TestClient(app_module.create_app(Settings.from_dict({"mesh": {"index_parallel": 8}}),
                                          device="cpu"))
    jtc = JTestClient(japp_module.create_app(
        settings=JSettings.model_validate({"mesh": {"index_parallel": 8}})))
    try:
        for client in (tc, jtc):
            r = client.post("/index/load", json_body={"index_dir": idx_dir})
            assert r.status == 200, r.json()
        state = tc.app.state
        assert isinstance(state.fused_searcher, ShardedFusedSearcher)
        assert state.sharded_index.n_shards == jtc.app.state.sharded_index.n_shards == 8
        assert state.sharded_index.rows_per_shard == 128  # 300 rows: shards 3-7 padding
        want_unsharded = _unsharded_ids(ts, idx_dir, k)
        for q, unsharded in zip(QUERIES, want_unsharded):
            body = tc.post("/search", json_body={"query": q, "k": k}).json()
            want = jtc.post("/search", json_body={"query": q, "k": k}).json()
            assert _ids(body) == _ids(want) == unsharded
            assert all(r["text"] is not None for r in body["results"])  # texts stay host-side
    finally:
        tc.close()
        jtc.close()


def test_preloaded_index_is_sharded_at_startup(monkeypatch, pair, cpu_entries):
    js, ts, idx_dir = pair
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **kw: ts)
    monkeypatch.setattr(japp_module, "StudentModel", lambda *a, **kw: js)
    settings = Settings.from_dict({"mesh": {"index_parallel": 4}})
    tc = TestClient(app_module.create_app(settings, device="cpu", preload_index_dir=idx_dir))
    jtc = JTestClient(japp_module.create_app(
        settings=JSettings.model_validate({"mesh": {"index_parallel": 4}}),
        preload_index_dir=idx_dir))
    try:
        assert tc.app.state.sharded_index.n_shards == 4
        assert tc.get("/health").json()["index_size"] == len(DOCS)
        for q, unsharded in zip(QUERIES, _unsharded_ids(ts, idx_dir, 5)):
            body = tc.post("/search", json_body={"query": q, "k": 5}).json()
            want = jtc.post("/search", json_body={"query": q, "k": 5}).json()
            assert _ids(body) == _ids(want) == unsharded
    finally:
        tc.close()
        jtc.close()


def test_a_mesh_the_devices_cannot_hold_fails_the_load(monkeypatch, pair):
    """Eight shards over one CPU entry (no --cpu-devices): refused, as the
    JAX mesh refuses more shards than devices; never served unsharded."""
    _, ts, idx_dir = pair
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **kw: ts)
    monkeypatch.setattr(mesh_module, "_cpu_devices", 1)
    with pytest.raises(ValueError, match="must divide device count 1"):
        with TestClient(app_module.create_app(Settings.from_dict(
                {"mesh": {"index_parallel": 8}}), device="cpu", preload_index_dir=idx_dir)):
            pass


def test_host_refine_storage_is_ignored_under_sharding(monkeypatch, pair, cpu_entries,
                                                       tmp_path, caplog):
    """A refined index keeps its refine rows on each shard (with the JAX
    app's warning), and serves the single-device refined engine's ids."""
    js, ts, _ = pair
    emb = js.encode_documents(DOCS)
    ids = [f"d{i}" for i in range(len(DOCS))]
    JBuilder(64, index_type="approx", dtype="int8", refine_m=40).build_from_arrays(
        emb, ids, texts=DOCS).save(tmp_path / "idx")
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **kw: ts)
    settings = Settings.from_dict({"mesh": {"index_parallel": 2},
                                   "index": {"refine_storage": "host"}})
    tc = TestClient(app_module.create_app(settings, device="cpu",
                                          preload_index_dir=str(tmp_path / "idx")))
    try:
        assert tc.app.state.sharded_index.refine_m == 40
        assert "refine_storage='host' ignored" in caplog.text
        want = _unsharded_ids(ts, str(tmp_path / "idx"), 5)
        for q, want_ids in zip(QUERIES, want):
            assert _ids(tc.post("/search", json_body={"query": q, "k": 5}).json()) == want_ids
    finally:
        tc.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_shards_cpu_devices_process_answers_the_unsharded_ids(pair, tmp_path):
    _, ts, idx_dir = pair
    ts.save(tmp_path / "student")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMANTIC_KD_")}
    env.update(PYTHONPATH=str(ROOT), SSKD_LOG_SYNC="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sskd_tpu_torch.cli.main", "serve", "--shards", "2",
         "--cpu-devices", "2", "--host", "127.0.0.1", "--port", str(port),
         "--model", str(tmp_path / "student"), "--index", idx_dir],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline, ready = time.monotonic() + 90, False
        while time.monotonic() < deadline and not ready and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=5) as r:
                    ready = r.status == 200
            except OSError:
                time.sleep(0.3)
        assert ready, proc.stderr.read()[-2000:] if proc.poll() is not None else "not ready"
        for q, want in zip(QUERIES, _unsharded_ids(ts, idx_dir, 5)):
            assert _ids(_post(port, "/search", {"query": q, "k": 5})) == want
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        proc.stderr.close()

