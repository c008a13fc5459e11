"""The port's app with reranking on the CPU: ``/search`` with ``rerank=true``
orders the bi-encoder's top ``rerank_top_k`` by the teacher's scores, as the
JAX app does; a timeout degrades to the bi-encoder order, a teacher
checkpoint that cannot be read disables reranking at startup, and an error
raised inside the teacher's forward fails the request or the startup."""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.models.teacher import TeacherModel as JTeacher
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.serve import app as app_module
from sskd_tpu_torch.serve.http import Request, TestClient
from sskd_tpu_torch.tokenization import WordPieceTokenizer

DOCS = [f"document about topic {i} with words {i * 7 % 13} and {i % 5}" for i in range(40)]
QUERIES = ["find topic 3", "words 5 topic", "what about topic 17"]
TEACHER_ARCH = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                    pad_token_id=1, position_style="roberta")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny student and index, and a tiny teacher saved in the port's
    format with the JAX teacher's parameters."""
    jtok = JTokenizer.build_from_corpus(DOCS + ["query passage what find about"],
                                        vocab_size=512)
    tok = WordPieceTokenizer(jtok.vocab)
    js = JStudent("tiny-serve", config=JConfig.tiny(vocab_size=jtok.vocab_size),
                  tokenizer=jtok)
    ts = StudentModel("tiny-serve", device="cpu", config=BertConfig.tiny(vocab_size=tok.vocab_size),
                      tokenizer=tok, params=jax.tree_util.tree_map(np.asarray, js.params))
    idx_dir = tmp_path_factory.mktemp("idx")
    b = IndexBuilder(64, index_type="exact", dtype="int8", device="cpu")
    b.build_from_arrays(ts.encode_documents(DOCS), [f"d{i}" for i in range(len(DOCS))],
                        texts=DOCS)
    b.save(idx_dir)
    jt = JTeacher("tiny-teacher", config=JConfig(vocab_size=jtok.vocab_size, **TEACHER_ARCH),
                  tokenizer=jtok, seed=4)
    tt = TeacherModel("tiny-teacher", device="cpu",
                      config=BertConfig(vocab_size=tok.vocab_size, **TEACHER_ARCH),
                      tokenizer=tok, params=jax.tree_util.tree_map(np.asarray, jt.params))
    teacher_dir = tt.save(tmp_path_factory.mktemp("teacher") / "t")
    return ts, str(idx_dir), tt, jt, str(teacher_dir)


def _client(monkeypatch, ts, idx_dir, teacher_dir, **search):
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **k: ts)
    settings = Settings.from_dict({
        "index": {"search_method": "exact"},
        "search": {"rerank_enabled": True, **search},
        "teacher": {"model_name": teacher_dir, "batch_size": 4},
    })
    return TestClient(app_module.create_app(settings, device="cpu", preload_index_dir=idx_dir))


def _ids(body):
    return [r["doc_id"] for r in body["results"]]


def test_rerank_orders_by_the_teacher_scores(monkeypatch, setup):
    """rerank=true: the top rerank_top_k of the bi-encoder, scored by the
    teacher in chunks of teacher.batch_size, in the order of its logits
    (the scores served), the first k of them, reranked: true; the same
    order and scores as the JAX teacher gives those pairs (f32 summation
    order, 1e-5)."""
    ts, idx_dir, tt, jt, teacher_dir = setup
    tc = _client(monkeypatch, ts, idx_dir, teacher_dir)
    try:
        assert tc.app.state.teacher is not None
        for q in QUERIES:
            plain = tc.post("/search", json_body={"query": q, "k": 10}).json()
            assert plain["reranked"] is False
            body = tc.post("/search", json_body={"query": q, "k": 5, "rerank": True,
                                                 "rerank_top_k": 10}).json()
            assert body["reranked"] is True and body["total_results"] == 5
            pairs = [(q, r["text"]) for r in plain["results"]]
            want = tt.score(pairs, batch_size=4)
            order = sorted(range(10), key=lambda i: -want[i])[:5]
            assert _ids(body) == [plain["results"][i]["doc_id"] for i in order]
            assert [r["score"] for r in body["results"]] == [want[i] for i in order]
            assert [r["rank"] for r in body["results"]] == [1, 2, 3, 4, 5]
            jwant = jt.score(pairs)
            np.testing.assert_allclose([r["score"] for r in body["results"]],
                                       [jwant[i] for i in order], rtol=1e-5, atol=1e-6)
            assert order == sorted(range(10), key=lambda i: -jwant[i])[:5]
        metrics = tc.get("/metrics").body.decode()
        assert "semantic_kd_rerank_trigger_total 3.0" in metrics
        assert "semantic_kd_rerank_latency_seconds_count 3.0" in metrics
    finally:
        tc.close()


def test_rerank_fetches_the_requests_rerank_top_k(monkeypatch, setup):
    ts, idx_dir, tt, jt, teacher_dir = setup
    tc = _client(monkeypatch, ts, idx_dir, teacher_dir)
    seen = []
    real = tc.app.state.teacher.score
    tc.app.state.teacher.score = lambda pairs, bs: seen.append((len(pairs), bs)) or real(pairs, bs)
    try:
        body = tc.post("/search", json_body={"query": QUERIES[0], "k": 3, "rerank": True}).json()
        assert body["reranked"] is True and len(body["results"]) == 3
        assert seen == [(40, 4)]  # the default 50, capped at the 40 rows
        tc.post("/search", json_body={"query": QUERIES[0], "k": 3, "rerank": True,
                                      "rerank_top_k": 7})
        assert seen[-1] == (7, 4)
    finally:
        tc.close()


def test_concurrent_reranks_through_the_batcher(monkeypatch, setup):
    ts, idx_dir, tt, jt, teacher_dir = setup
    tc = _client(monkeypatch, ts, idx_dir, teacher_dir)
    try:
        async def burst():
            reqs = [Request("POST", "/search",
                            body=f'{{"query": "{q}", "k": 4, "rerank": true}}'.encode())
                    for q in QUERIES]
            return await asyncio.gather(*(tc.app.handle(r) for r in reqs))

        responses = tc._loop.run_until_complete(burst())
        for q, r in zip(QUERIES, responses):
            assert r.status == 200 and r.json()["reranked"] is True
            single = tc.post("/search", json_body={"query": q, "k": 4, "rerank": True}).json()
            assert r.json()["results"] == single["results"]
    finally:
        tc.close()


def test_a_timeout_degrades_to_the_bi_encoder_order(monkeypatch, setup):
    ts, idx_dir, tt, jt, teacher_dir = setup
    tc = _client(monkeypatch, ts, idx_dir, teacher_dir, rerank_timeout_ms=1.0)
    real = tc.app.state.teacher.score

    def slow(pairs, bs):
        time.sleep(0.2)
        return real(pairs, bs)

    tc.app.state.teacher.score = slow
    try:
        plain = tc.post("/search", json_body={"query": QUERIES[1], "k": 6}).json()
        body = tc.post("/search", json_body={"query": QUERIES[1], "k": 6, "rerank": True}).json()
        assert body["reranked"] is False
        assert body["results"] == plain["results"]
        assert "semantic_kd_rerank_trigger_total 1.0" in tc.get("/metrics").body.decode()
    finally:
        tc.close()


def test_an_unreadable_teacher_checkpoint_disables_rerank(monkeypatch, setup, tmp_path):
    """A checkpoint directory whose weights file is cut short: the app starts
    with reranking off, as the JAX app does, and rerank=true is answered in
    the bi-encoder order with reranked: false."""
    ts, idx_dir, tt, jt, teacher_dir = setup
    bad = tt.save(tmp_path / "bad")
    raw = (bad / "weights.pt").read_bytes()
    (bad / "weights.pt").write_bytes(raw[: len(raw) // 3])
    tc = _client(monkeypatch, ts, idx_dir, str(bad))
    try:
        assert tc.app.state.ready and tc.app.state.teacher is None
        plain = tc.post("/search", json_body={"query": QUERIES[2], "k": 5}).json()
        body = tc.post("/search", json_body={"query": QUERIES[2], "k": 5, "rerank": True}).json()
        assert body["reranked"] is False and body["results"] == plain["results"]
    finally:
        tc.close()


def test_an_error_inside_the_teachers_forward_propagates(monkeypatch, setup):
    """A device or kernel error is not a reason to serve reranked: false: in
    a request it fails the request, at startup the startup."""
    ts, idx_dir, tt, jt, teacher_dir = setup
    tc = _client(monkeypatch, ts, idx_dir, teacher_dir)

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    tc.app.state.teacher.module.forward = broken
    try:
        r = tc.post("/search", json_body={"query": QUERIES[0], "k": 5, "rerank": True})
        assert r.status == 500 and "reranked" not in r.json()
        assert tc.post("/search", json_body={"query": QUERIES[0], "k": 5}).status == 200
    finally:
        tc.close()

    def failing_teacher(*args, **kwargs):
        raise RuntimeError("CUDA error: no kernel image is available for execution")

    monkeypatch.setattr(app_module, "TeacherModel", failing_teacher)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _client(monkeypatch, ts, idx_dir, teacher_dir)


def test_a_model_name_that_is_no_directory_gives_a_seeded_teacher(monkeypatch, setup):
    """As in the JAX package: no checkpoint on disk means seeded random
    weights (the tiny config unless the name says reranker), and the same
    seed gives the same teacher."""
    ts, idx_dir, tt, jt, teacher_dir = setup
    tc = _client(monkeypatch, ts, idx_dir, "tiny-cross-encoder")
    try:
        teacher = tc.app.state.teacher
        assert teacher.config == BertConfig.tiny()
        body = tc.post("/search", json_body={"query": QUERIES[0], "k": 3, "rerank": True}).json()
        assert body["reranked"] is True
        again = TeacherModel("tiny-cross-encoder", device="cpu").module.state_dict()
        assert all(torch.equal(v, again[k]) for k, v in teacher.module.state_dict().items())
    finally:
        tc.close()


def test_rerank_off_by_default(monkeypatch, setup):
    ts, idx_dir, tt, jt, teacher_dir = setup
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **k: ts)
    tc = TestClient(app_module.create_app(Settings.from_dict({"index": {"search_method": "exact"}}),
                                          device="cpu", preload_index_dir=idx_dir))
    try:
        assert tc.app.state.teacher is None
        body = tc.post("/search", json_body={"query": QUERIES[0], "k": 3, "rerank": True}).json()
        assert body["reranked"] is False and len(body["results"]) == 3
    finally:
        tc.close()
