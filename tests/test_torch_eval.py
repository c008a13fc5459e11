"""Port vs JAX: evaluation. The metrics, the chunker, the evaluation inputs
and KDEvaluator over the JAX package's own checkpoints and demo data.

Everything runs on the CPU: the port with ``device="cpu"`` (the plain
top-k engine and plain attention), JAX with its XLA path. The same inputs
go to both: seeded numpy lists for the metrics, seeded texts for the
chunker, and ``artifacts/demo/data/raw/demo/test.jsonl`` (90 queries, 871
passages) with ``artifacts/demo/{vanilla, run_kd/best_model, teacher}`` for
the evaluator. Metric functions agree within 1e-12; the evaluator's
metrics within 1e-3 (embeddings differ by f32 summation order, which can
swap a near-tie in a ranking).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from sskd_tpu.cli.pipeline import build_training_inputs as j_build_inputs
from sskd_tpu.cli.pipeline import load_eval_inputs as j_load_eval_inputs
from sskd_tpu.data.prepare import _iter_passages_graded as j_iter_graded
from sskd_tpu.kd.eval import KDEvaluator as JEvaluator
from sskd_tpu.models.student import StudentModel as JStudent
from sskd_tpu.models.teacher import TeacherModel as JTeacher
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu.utils import chunk as jchunk
from sskd_tpu.utils import metrics as jmetrics
from sskd_tpu_torch.cli.pipeline import build_training_inputs, load_eval_inputs
from sskd_tpu_torch.data.prepare import _iter_passages_graded
from sskd_tpu_torch.exceptions import DataError
from sskd_tpu_torch.kd.eval import KDEvaluator
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.tokenization import WordPieceTokenizer
from sskd_tpu_torch.utils import chunk as tchunk
from sskd_tpu_torch.utils import metrics as tmetrics

ROOT = Path(__file__).resolve().parent.parent
DEMO = ROOT / "artifacts" / "demo"
TEST_JSONL = DEMO / "data" / "raw" / "demo" / "test.jsonl"
WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu xi "
         "omicron pi rho sigma tau upsilon phi chi psi omega, what is the. of a").split()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _graded(seed, n=40):
    rng = np.random.default_rng(seed)
    return [rng.choice([0.0, 0.0, 1.0, 2.0, 3.0], int(rng.integers(0, 25))).tolist()
            for _ in range(n)]


def _metric_cases(seed):
    """(name, args) for every metric function, on seeded graded lists."""
    rng = np.random.default_rng(seed)
    lists = _graded(seed)
    conf, acc = rng.random(300), (rng.random(300) > 0.4).astype(float)
    conf[:5] = [0.0, 1.0, 0.1, 0.5, 0.5]
    a, b = rng.standard_normal(30), rng.standard_normal(30)
    results = {f"q{i}": rels for i, rels in enumerate(lists)}
    total = {f"q{i}": int(rng.integers(0, 30)) for i in range(0, len(lists), 2)}
    cases = []
    for k in (1, 5, 10, 20):
        for rels in lists[:10]:
            cases += [("ndcg_at_k", (rels, k)), ("mrr_at_k", (rels, k)),
                      ("precision_at_k", (rels, k)),
                      ("recall_at_k", (rels, int(rng.integers(0, 12)), k)),
                      ("ndcg_at_k_standard", (rels, rels + [2.0, 3.0, 0.0], k))]
    cases += [("precision_at_k", ([1.0], 0)), ("ndcg_at_k", ([], 10)),
              ("expected_calibration_error", (conf, acc)),
              ("expected_calibration_error", (conf, acc, 7)),
              ("expected_calibration_error", ([], [])),
              ("kendall_tau", (a, b)), ("kendall_tau", (a, a)), ("kendall_tau", ([1.0], [2.0])),
              ("kendall_tau", (np.ones(5), np.arange(5.0))),
              ("risk_coverage_curve", (conf, acc)), ("risk_coverage_curve", ([], [])),
              ("compute_retrieval_metrics", (results, total)),
              ("compute_retrieval_metrics", (results, None, (1, 3, 10))),
              ("compute_retrieval_metrics", ({}, None))]
    return cases


def _close(got, want, tol):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=tol)
        assert type(got) is type(want)


@pytest.mark.parametrize("name", ["ndcg_at_k", "ndcg_at_k_standard", "mrr_at_k", "recall_at_k",
                                  "precision_at_k", "expected_calibration_error",
                                  "kendall_tau", "risk_coverage_curve",
                                  "compute_retrieval_metrics"])
def test_metric_matches_jax(name):
    cases = [args for n, args in _metric_cases(0) + _metric_cases(1) if n == name]
    assert cases
    for args in cases:
        _close(getattr(tmetrics, name)(*args), getattr(jmetrics, name)(*args), 1e-12)


# ---------------------------------------------------------------------------
# Chunking
# ---------------------------------------------------------------------------


def _texts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizers():
    corpus = [" ".join(WORDS)]
    return (JTokenizer.build_from_corpus(corpus, vocab_size=200),
            WordPieceTokenizer.build_from_corpus(corpus, vocab_size=200))


@pytest.mark.parametrize("max_tokens,stride", [(512, 80), (16, 4), (7, 0), (5, 4)])
def test_chunker_matches_jax(tokenizers, max_tokens, stride):
    """Equal chunks (text, character span, token count, index) over ASCII
    texts of 0-700 words, and non-ASCII ones (the pure Python path)."""
    jtok, tok = tokenizers
    jc = jchunk.TextChunker(jtok, max_tokens=max_tokens, stride=stride)
    tc = tchunk.TextChunker(tok, max_tokens=max_tokens, stride=stride)
    texts = _texts(2, 12, 0, 700) + ["", "   ", "Ünïcode wörds, ☃ and ascii", "x" * 150]
    for text in texts:
        assert [c.to_dict() for c in tc.chunk_text(text)] == \
            [c.to_dict() for c in jc.chunk_text(text)]
    assert [[c.to_dict() for c in cs] for cs in tc.chunk_batch(texts[:3])] == \
        [[c.to_dict() for c in cs] for cs in jc.chunk_batch(texts[:3])]
    for bad in ((0, 0), (8, 8), (8, -1)):
        with pytest.raises(ValueError):
            tchunk.TextChunker(tok, *bad)


def test_maxsim_and_text_overlap_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal(60).astype(np.float32)
    doc_ids = [f"d{i}" for i in rng.integers(0, 17, 60)]
    assert tchunk.maxsim_aggregation(scores, doc_ids) == jchunk.maxsim_aggregation(scores,
                                                                                  doc_ids)
    for k in (1, 5, 40):
        tv, ti = tchunk.maxsim_aggregate_topk(scores, doc_ids, k)
        jv, ji = jchunk.maxsim_aggregate_topk(scores, doc_ids, k)
        assert ti == ji and tv.dtype == jv.dtype and np.array_equal(tv, jv)
    tv, ti = tchunk.maxsim_aggregate_topk(np.array([]), [], 3)
    assert ti == [] and tv.size == 0
    texts = _texts(4, 10, 0, 12) + ["", "ab", "AB", "abc"]
    for a in texts:
        for b in texts:
            for n in (1, 3, 5):
                assert tchunk.compute_text_overlap(a, b, n) == jchunk.compute_text_overlap(a, b, n)


# ---------------------------------------------------------------------------
# The evaluation inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_samples", [None, 12])
def test_eval_inputs_match_jax(max_samples):
    """(queries, corpus, qrels) from the demo split and its qrels sidecar,
    and the training inputs behind them."""
    assert load_eval_inputs(TEST_JSONL, max_samples) == \
        j_load_eval_inputs(TEST_JSONL, max_samples)
    assert build_training_inputs(TEST_JSONL, max_samples) == \
        j_build_inputs(TEST_JSONL, max_samples)


def test_passage_layouts_match_jax(tmp_path):
    """Both MS MARCO layouts, with and without grades; an unknown one
    raises DataError; a split without a sidecar keeps row-local grades."""
    rows = [
        {"passages": {"passage_text": ["a b", "c d"], "is_selected": [1, 0]}},
        {"passages": {"passage_text": ["e", "f", "g"], "is_selected": [0, 1, 0],
                      "relevance_grade": [1, 2, 0]}},
        {"passages": [{"passage_text": "h", "is_selected": 1, "relevance_grade": 2},
                      {"passage_text": "i"}]},
        {"query": "none"},
    ]
    for row in rows:
        assert list(_iter_passages_graded(row)) == list(j_iter_graded(row))
    with pytest.raises(DataError):
        list(_iter_passages_graded({"passages": "text"}))
    raw = tmp_path / "split.jsonl"
    raw.write_text("\n".join(
        f'{{"query_id": {i}, "query": "q{i}", "passages": {{"passage_text": '
        f'["p{i}", "shared", "p{i}x"], "is_selected": [1, 0, {i % 2}]}}}}' for i in range(6)))
    assert load_eval_inputs(raw) == j_load_eval_inputs(raw)
    assert load_eval_inputs(raw, 2) == j_load_eval_inputs(raw, 2)


# ---------------------------------------------------------------------------
# KDEvaluator on the repository's checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_inputs():
    return load_eval_inputs(TEST_JSONL, 600)


@pytest.fixture(scope="module")
def students():
    """{name: (JAX model, port model)} for the two demo students."""
    return {name: (JStudent(str(DEMO / path), device="cpu"),
                   StudentModel(str(DEMO / path), device="cpu"))
            for name, path in (("kd_student", "run_kd/best_model"), ("vanilla", "vanilla"))}


@pytest.fixture(scope="module")
def teachers():
    return (JTeacher(str(DEMO / "teacher"), device="cpu"),
            TeacherModel(str(DEMO / "teacher"), device="cpu"))


def _within(got: dict, want: dict, tol: float = 1e-3) -> None:
    assert set(got) == set(want)
    worst = max(abs(got[k] - want[k]) for k in want)
    assert worst <= tol, (worst, got, want)


@pytest.fixture(scope="module")
def jax_rows(students, demo_inputs):
    """The JAX evaluator's metrics of both students on the demo split."""
    ev = JEvaluator()
    return {name: ev.evaluate_retrieval(jm, *demo_inputs) for name, (jm, _) in students.items()}


@pytest.fixture(scope="module")
def port_rows(students, demo_inputs):
    ev = KDEvaluator(device="cpu")
    return {name: ev.evaluate_retrieval(tm, *demo_inputs) for name, (_, tm) in students.items()}


@pytest.mark.parametrize("name", ["kd_student", "vanilla"])
def test_retrieval_on_the_demo_checkpoints_matches_jax(port_rows, jax_rows, name):
    _within(port_rows[name], jax_rows[name])


def test_compare_models_and_report_match_jax(students):
    """compare_models on the first 30 queries: the same rows
    (``DataFrame.to_dict(orient="index")`` of the JAX result) and the same
    gate, gated against vanilla (the JAX compare_models ranks every row with
    the bi-encoder path; the demo's own gate, against the teacher's row, is
    below); no gate without the teacher's row; the same report."""
    inputs = load_eval_inputs(TEST_JSONL, 30)
    models_t = {name: tm for name, (_, tm) in students.items()}
    models_j = {name: jm for name, (jm, _) in students.items()}
    rows, gate = KDEvaluator(device="cpu").compare_models(models_t, *inputs,
                                                          teacher_name="vanilla")
    df, jgate = JEvaluator().compare_models(models_j, *inputs, teacher_name="vanilla")
    jrows = df.to_dict(orient="index")
    assert list(rows) == list(jrows) and gate == jgate and list(gate) == ["kd_student"]
    for name in rows:
        _within(rows[name], jrows[name])
    _, none = KDEvaluator(device="cpu").compare_models({"vanilla": models_t["vanilla"]}, *inputs)
    assert none is None
    report = KDEvaluator.generate_report(rows, title="Model comparison")
    assert report == JEvaluator.generate_report(jrows, title="Model comparison")
    assert report.splitlines()[2].startswith("| model | mrr@1 |")


def test_teacher_retrieval_matches_jax_and_the_gate_fails(teachers, jax_rows, port_rows):
    """evaluate_retrieval_teacher at max_samples 24 (O(Q x N) pairs), and
    the demo's gate: kd_student's nDCG@10 on the whole split against 0.95 x
    the teacher's (its teacher_metrics.json) is FAILED under both
    packages."""
    inputs = load_eval_inputs(TEST_JSONL, 24)
    jt, tt = teachers
    got = KDEvaluator(device="cpu").evaluate_retrieval_teacher(tt, *inputs)
    _within(got, JEvaluator().evaluate_retrieval_teacher(jt, *inputs))
    teacher_ndcg = json.loads((DEMO / "teacher_metrics.json").read_text())["ndcg@10"]
    assert jax_rows["kd_student"]["ndcg@10"] < 0.95 * teacher_ndcg
    assert port_rows["kd_student"]["ndcg@10"] < 0.95 * teacher_ndcg


def test_chunked_reranked_and_ranking_quality_match_jax(students, teachers, demo_inputs):
    """evaluate_retrieval_chunked over the demo corpus cut by each package's
    TextChunker (16-token windows, stride 4: every passage in at least 2 chunks);
    evaluate_retrieval_reranked with the demo teacher, rerank_k 10;
    evaluate_ranking_quality on 12 queries x 6 passages against seeded
    teacher scores (Kendall tau, ECE)."""
    jm, tm = students["kd_student"]
    jt, tt = teachers
    q_map, corpus, qrels = demo_inputs
    q_small = dict(list(q_map.items())[:30])
    doc_ids = list(corpus)[:300]
    chunks_t, chunks_j = [], []
    for chunker, out in ((tchunk.TextChunker(tm.tokenizer, 16, 4), chunks_t),
                         (jchunk.TextChunker(jm.tokenizer, 16, 4), chunks_j)):
        for d in doc_ids:
            out += [(c.text, d) for c in chunker.chunk_text(corpus[d])]
    assert chunks_t == chunks_j and len(chunks_t) >= 2 * len(doc_ids)
    texts, owners = [c for c, _ in chunks_t], [d for _, d in chunks_t]
    ev, jev = KDEvaluator(device="cpu"), JEvaluator()
    _within(ev.evaluate_retrieval_chunked(tm, q_small, texts, owners, qrels),
            jev.evaluate_retrieval_chunked(jm, q_small, texts, owners, qrels))
    sub = {d: corpus[d] for d in doc_ids}
    got = ev.evaluate_retrieval_reranked(tm, tt, q_small, sub, qrels, rerank_k=10)
    assert set(got) == {f"{m}@{k}" for m in ("ndcg", "mrr", "precision", "recall")
                        for k in (1, 5, 10)}
    _within(got, jev.evaluate_retrieval_reranked(jm, jt, q_small, sub, qrels, rerank_k=10))
    rng = np.random.default_rng(5)
    queries = list(q_map.values())[:12]
    docs = [[corpus[d] for d in rng.choice(doc_ids, 6, replace=False)] for _ in queries]
    t_scores = rng.standard_normal((12, 6)).tolist()
    binary = (rng.random((12, 6)) > 0.5).astype(int).tolist()
    for qb in (None, binary):
        _within(ev.evaluate_ranking_quality(tm, queries, docs, t_scores, qb),
                jev.evaluate_ranking_quality(jm, queries, docs, t_scores, qb), 1e-6)


def test_evaluator_defaults_to_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KDEvaluator()
    assert KDEvaluator(k_values=(3,), device="cpu").k_values == (3,)
