"""Port vs JAX: BM25 over chunk files and the three-stage miners.

- ``BM25Index.build_from_parquet`` (through the port's parquet reader) gives
  the JAX index's doc ids, and ``get_scores`` within 1e-6 of its;
  ``get_doc_text``, ``exists`` and ``build_bm25_index`` as in JAX.
- Stages 1-3 of ``build_mining_curriculum``, ``TeacherMiner``, ``ANCEMiner``
  and ``refresh_ance_negatives`` equal the JAX miners' results with the JAX
  tests' fake teacher and student (ids equal, scores within 1e-6 relative).
- With the repository's demo teacher (``artifacts/demo/teacher``, read
  from params.msgpack) and the demo train split, the first 8 queries' stage-2
  negatives equal ``artifacts/demo/run_kd/mined_stage2.json``, which the JAX
  package mined: ids equal, scores within 1e-5 (1 + |s|).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sskd_tpu.mining import bm25 as j_bm25
from sskd_tpu.mining import miners as j_miners
from sskd_tpu_torch.cli.pipeline import build_training_inputs
from sskd_tpu_torch.data.parquet import write_parquet
from sskd_tpu_torch.exceptions import DataError
from sskd_tpu_torch.mining import bm25 as t_bm25
from sskd_tpu_torch.mining import miners as t_miners
from test_bm25_mining import CORPUS, CORPUS_TEXTS, DOC_IDS, PerTextStudent, PerTextTeacher

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "artifacts" / "demo"
CHUNKS = ROOT / "artifacts" / "demo" / "data" / "chunks" / "demo" / "validation.parquet"


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs several workers on one
    machine, and more threads than cores slow every worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _same(got, want, rtol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.doc_ids == w.doc_ids
        np.testing.assert_allclose(g.scores, w.scores, rtol=rtol, atol=0)


def test_build_from_parquet_matches_jax(tmp_path):
    want = j_bm25.BM25Index().build_from_parquet(CHUNKS, max_docs=600)
    got = t_bm25.BM25Index().build_from_parquet(CHUNKS, max_docs=600)
    assert got.doc_ids == want.doc_ids and got.ntotal == 600
    for query in ("what is ember kettle", "history of river cargo", "explain nothing here"):
        np.testing.assert_allclose(got.get_scores(query), want.get_scores(query), rtol=0,
                                   atol=1e-6)
        assert got.search(query, 10) == want.search(query, 10)
    doc = want.doc_ids[17]
    assert got.get_doc_text(doc) == want.get_doc_text(doc)
    with pytest.raises(DataError):
        got.get_doc_text("no such doc")
    idx = t_bm25.build_bm25_index(CHUNKS, tmp_path / "bm", max_docs=50)
    assert t_bm25.BM25Index.exists(tmp_path / "bm") and idx.ntotal == 50
    assert j_bm25.BM25Index.load(tmp_path / "bm").doc_ids == idx.doc_ids
    assert not t_bm25.BM25Index.exists(tmp_path / "none")


def test_build_from_parquet_takes_integer_ids(tmp_path):
    path = write_parquet(tmp_path / "c.parquet", {"id": [3, 1, 2], "body": CORPUS_TEXTS[:3]})
    idx = t_bm25.BM25Index().build_from_parquet(path, text_column="body", id_column="id")
    assert idx.doc_ids == ["3", "1", "2"]


def _bm25s():
    return (j_bm25.BM25Index().build(CORPUS_TEXTS, DOC_IDS),
            t_bm25.BM25Index().build(CORPUS_TEXTS, DOC_IDS))


QUERIES = ["the cat", "dog yard", "python maths", "cats and dogs"]
POSITIVES = [["the cat sat on the mat"], [CORPUS["d1"]], ["py"], []]
POSITIVE_IDS = [["d0"], ["d1"], [], []]


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("denoise", [1.0, 0.5])
def test_curriculum_matches_jax(stage, denoise, fake_teacher, fake_student):
    """Each stage on the JAX tests' fake teacher (seeded scores per call)
    and student (seeded embeddings per text)."""
    jb, tb = _bm25s()
    kw = dict(positive_ids_per_query=POSITIVE_IDS, bm25_top_k=4, teacher_top_k=3,
              teacher_confidence_threshold=0.3, ance_top_k=2, ance_margin=1.5,
              denoise_threshold=denoise)
    want = j_miners.build_mining_curriculum(stage, QUERIES, POSITIVES, CORPUS, jb,
                                            teacher=fake_teacher, student=fake_student, **kw)
    got = t_miners.build_mining_curriculum(stage, QUERIES, POSITIVES, CORPUS, tb,
                                           teacher=fake_teacher, student=fake_student, **kw)
    _same(got, want)
    assert any(m.doc_ids for m in got)


def test_teacher_and_ance_miners_match_jax():
    cands = [["d0", "d1", "d3", "missing"], ["d1", "d3", "d4"], [], ["d0", "d2", "d3", "d4"]]
    want = j_miners.TeacherMiner(PerTextTeacher(), top_k=3, confidence_threshold=0.5).mine(
        QUERIES, cands, CORPUS)
    teacher = PerTextTeacher()
    got = t_miners.TeacherMiner(teacher, top_k=3, confidence_threshold=0.5).mine(
        QUERIES, cands, CORPUS)
    assert teacher.calls == 1  # one global score call
    _same(got, want)
    want = j_miners.ANCEMiner(PerTextStudent(), margin=0.6, top_k=3).mine(
        QUERIES, POSITIVES, cands, CORPUS)
    student = PerTextStudent()
    got = t_miners.ANCEMiner(student, margin=0.6, top_k=3).mine(QUERIES, POSITIVES, cands, CORPUS)
    assert student.calls == 2  # one query encode, one deduplicated document encode
    _same(got, want)
    pool = t_miners.TeacherMiner(PerTextTeacher(), top_k=4, confidence_threshold=0.0).mine(
        QUERIES, cands, CORPUS)
    want = j_miners.refresh_ance_negatives(PerTextStudent(), QUERIES, POSITIVES, pool, CORPUS,
                                           ance_top_k=2, ance_margin=2.0)
    got = t_miners.refresh_ance_negatives(PerTextStudent(), QUERIES, POSITIVES, pool, CORPUS,
                                          ance_top_k=2, ance_margin=2.0)
    _same(got, want)
    assert all(len(m.doc_ids) <= 5 + 2 for m in got)


def test_curriculum_validates_its_stage():
    _, tb = _bm25s()
    with pytest.raises(ValueError):
        t_miners.build_mining_curriculum(4, [], [], CORPUS, tb)
    with pytest.raises(ValueError):
        t_miners.build_mining_curriculum(2, ["q"], [[]], CORPUS, tb)
    with pytest.raises(ValueError):
        t_miners.build_mining_curriculum(3, ["q"], [[]], CORPUS, tb, teacher=PerTextTeacher())


def test_demo_teacher_reproduces_the_jax_mined_negatives():
    """The JAX demo run's stage-2 negatives (bm25 top 100, teacher top 10,
    confidence 0.0, denoise 0.9) for the first 8 queries of its train
    split, from the repository's teacher and BM25 over all 420 rows."""
    from sskd_tpu_torch.models.teacher import TeacherModel

    queries, positives, pos_ids, corpus, _ = build_training_inputs(
        DEMO / "data" / "raw" / "demo" / "train.jsonl")
    assert len(queries) == 420
    ids = list(corpus)
    bm25 = t_bm25.BM25Index().build([corpus[i] for i in ids], ids)
    teacher = TeacherModel(str(DEMO / "teacher"), device="cpu")
    got = t_miners.build_mining_curriculum(
        2, queries[:8], positives[:8], corpus, bm25, teacher=teacher,
        positive_ids_per_query=pos_ids[:8], bm25_top_k=100, teacher_top_k=10,
        teacher_confidence_threshold=0.0, denoise_threshold=0.9)
    want = json.loads((DEMO / "run_kd" / "mined_stage2.json").read_text())[:8]
    for g, w in zip(got, want):
        assert g.doc_ids == w["doc_ids"]
        s, ws = np.asarray(g.scores), np.asarray(w["scores"])
        assert (np.abs(s - ws) / (1 + np.abs(ws))).max() <= 1e-5
