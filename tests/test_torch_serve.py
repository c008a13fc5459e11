"""The port's app on the CPU, through its in-process HTTP stack, against
sskd_tpu's fused search on the same carried-over tiny weights and index."""

import asyncio
from pathlib import Path

import jax
import numpy as np
import pytest

from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.serve.fused import FusedSearcher as JFused
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.serve import app as app_module
from sskd_tpu_torch.serve.http import Request, TestClient
from sskd_tpu_torch.tokenization import WordPieceTokenizer

DOCS = [f"document about topic {i} with words {i * 7 % 13}" for i in range(40)]
QUERIES = ["find topic 3", "words 5 topic", "what about topic 17", "document"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tok = JTokenizer.build_from_corpus(DOCS + ["query passage what find about"], vocab_size=512)
    js = JStudent("tiny-serve", config=JConfig.tiny(vocab_size=tok.vocab_size), tokenizer=tok)
    ts = StudentModel(
        "tiny-serve",
        device="cpu",
        config=BertConfig.tiny(vocab_size=tok.vocab_size),
        tokenizer=WordPieceTokenizer(tok.vocab),
        params=jax.tree_util.tree_map(np.asarray, js.params),
    )
    jb = JBuilder(embedding_dim=64, dtype="int8")
    jb.build_from_arrays(js.encode_documents(DOCS), [f"d{i}" for i in range(len(DOCS))],
                         texts=DOCS)
    idx_dir = tmp_path_factory.mktemp("idx")
    jb.save(idx_dir)
    return js, ts, jb, str(idx_dir)


def _client(monkeypatch, ts, idx_dir, **sections):
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **k: ts)
    settings = Settings.from_dict({"index": {"search_method": "exact"}, **sections})
    return TestClient(app_module.create_app(settings, device="cpu", preload_index_dir=idx_dir))


def test_search_matches_jax_fused(monkeypatch, pair):
    js, ts, jb, idx_dir = pair
    tc = _client(monkeypatch, ts, idx_dir)
    try:
        assert tc.get("/health").json()["status"] == "healthy"
        assert tc.get("/ready").status == 200
        assert tc.get("/live").json() == {"alive": True}
        _, want = JFused(js, jb).search_texts(QUERIES, k=5)
        for q, want_ids in zip(QUERIES, want):
            r = tc.post("/search", json_body={"query": q, "k": 5})
            assert r.status == 200, r.body
            body = r.json()
            assert [x["doc_id"] for x in body["results"]] == [f"d{i}" for i in want_ids]
            assert [x["rank"] for x in body["results"]] == [1, 2, 3, 4, 5]
            assert body["results"][0]["text"] == DOCS[want_ids[0]]
            assert r.headers["X-Content-Type-Options"] == "nosniff"
        metrics = tc.get("/metrics").body.decode()
        served = 'semantic_kd_requests_total{method="POST",path="/search",status="200"} 4.0'
        assert served in metrics
        assert "semantic_kd_index_size 40.0" in metrics
    finally:
        tc.close()


def test_batcher_merges_concurrent_requests(monkeypatch, pair):
    js, ts, jb, idx_dir = pair
    tc = _client(monkeypatch, ts, idx_dir)
    calls = []
    searcher = tc.app.state.fused_searcher
    real = searcher.search_texts
    searcher.search_texts = lambda qs, k: calls.append(len(qs)) or real(qs, k)
    try:
        async def burst():
            handle = tc.app.handle
            reqs = [Request("POST", "/search", body=f'{{"query": "{q}", "k": 3}}'.encode())
                    for q in QUERIES]
            return await asyncio.gather(*(handle(r) for r in reqs))

        responses = tc._loop.run_until_complete(burst())
        assert [r.status for r in responses] == [200] * len(QUERIES)
        assert sum(calls) == len(QUERIES) and max(calls) > 1
        single = tc.post("/search", json_body={"query": QUERIES[2], "k": 3}).json()
        assert responses[2].json()["results"] == single["results"]
    finally:
        tc.close()


def test_encode_and_validation(monkeypatch, pair):
    js, ts, jb, idx_dir = pair
    tc = _client(monkeypatch, ts, idx_dir)
    try:
        r = tc.post("/encode", json_body={"texts": ["a b", "topic 3"]})
        assert r.status == 200 and r.json()["dimension"] == 64
        np.testing.assert_allclose(
            np.array(r.json()["embeddings"]), js.encode(["a b", "topic 3"]), atol=1e-5
        )
        assert tc.post("/search", json_body={"query": "x", "k": 0}).status == 422
        assert tc.post("/search", json_body={"query": "", "k": 1}).status == 422
        assert tc.post("/search", json_body={"k": 1}).status == 422
        assert tc.post("/search", body=b"{not json").status == 422
    finally:
        tc.close()


def test_unported_configurations_fail_loudly(monkeypatch, pair):
    js, ts, jb, idx_dir = pair
    # rerank is served now (tests/test_torch_rerank.py); its fields are bounded
    with pytest.raises(ConfigError, match="rerank_top_k"):
        Settings.from_dict({"search": {"rerank_top_k": 201}})
    with pytest.raises(ConfigError, match="rerank_timeout_ms"):
        Settings.from_dict({"search": {"rerank_timeout_ms": 0}})
    with pytest.raises(ConfigError):
        Settings.from_dict({"search": {"default_k": 0}})
    # an unknown section is ignored, as pydantic ignores extras
    assert Settings.from_dict({"nosuch": {}}).to_dict() == Settings().to_dict()
    # refine is served now (tests/test_torch_refine.py); its fields are bounded
    assert Settings.from_dict({"index": {"refine_m": 64}}).index.refine_m == 64
    with pytest.raises(ConfigError, match="refine_m"):
        Settings.from_dict({"index": {"refine_m": -1}})
    with pytest.raises(ConfigError, match="refine_storage"):
        Settings.from_dict({"index": {"refine_storage": "disk"}})
    # the default search_method, approx, is a build-time setting: an exact
    # index loaded under it starts up and is served exactly
    tc = _client(monkeypatch, ts, idx_dir, index={"search_method": "approx"})
    try:
        assert tc.app.state.index_builder.index_type == "exact"
        assert tc.post("/search", json_body={"query": QUERIES[0], "k": 3}).status == 200
    finally:
        tc.close()


def test_index_recorded_approx_is_served_exactly(monkeypatch, pair):
    js, ts, jb, idx_dir = pair
    approx_dir = str(Path(idx_dir).parent / "approx_idx")
    jb.index_type = "approx"
    try:
        jb.save(approx_dir)
    finally:
        jb.index_type = "exact"
    # the index keeps the type it records, whatever search_method says (the
    # client's settings say exact), and is served by the approx engine: at 40
    # rows that engine does not reduce, on either side, hence "exactly"
    tc = _client(monkeypatch, ts, approx_dir)
    try:
        assert tc.app.state.index_builder.index_type == "approx"
        assert tc.app.state.fused_searcher._engine(16) == "approx"
        jb_approx = JBuilder().load(approx_dir)
        assert jb_approx.index_type == "approx"
        _, want = JFused(js, jb_approx).search_texts(QUERIES, k=3)
        for q, want_ids in zip(QUERIES, want):
            got = tc.post("/search", json_body={"query": q, "k": 3}).json()["results"]
            assert [r["doc_id"] for r in got] == [f"d{i}" for i in want_ids]
    finally:
        tc.close()


def test_env_overrides():
    s = Settings.from_env(environ={"SEMANTIC_KD_INDEX__SEARCH_METHOD": "exact",
                                   "SEMANTIC_KD_SERVICE__MICRO_BATCH_MAX_SIZE": "8",
                                   "SEMANTIC_KD_UNKNOWN__X": "1"})
    assert s.index.search_method == "exact" and s.service.micro_batch_max_size == 8
