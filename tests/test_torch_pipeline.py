"""Port vs JAX: ``run_train_pipeline`` (cli/pipeline.py).

Both packages run the pipeline over the same small inputs (the first rows
of the demo train and validation splits) with the repository's demo teacher
and vanilla student (``artifacts/demo``), stage 2 at the demo recipe's
confidence 0.0 (BM25's top 30: the teacher's pairs are most of the JAX
side's CPU time). The JAX run stops before its training (its trainer's
``train`` is replaced in this test: its jit compiles are not what is
compared); the port's trains on the CPU. Held: the mined caches are equal
(ids; scores within 1e-5 (1 + |s|)), the staleness guard re-mines in both,
the parquet the port prepared reads equal to the JAX one's, every loss of
the port's run is finite and ``best_model`` reloads. Beside that: the
``--tiny`` path at stage 3 (fitted vocabulary, generated demo data, the
in-training ANCE refresh) on the CPU, and what the port refuses.
"""

import json
import math
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from sskd_tpu.cli import pipeline as j_pipeline
from sskd_tpu.config import Settings as JSettings
from sskd_tpu.kd.train import KDTrainer as JKDTrainer
from sskd_tpu_torch.cli import pipeline as t_pipeline
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.data.parquet import read_parquet
from sskd_tpu_torch.exceptions import ConfigError, DataError
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.parallel.mesh import create_mesh

DEMO = Path(__file__).resolve().parents[1] / "artifacts" / "demo"
N_ROWS = 8  # rows of each raw split
RECIPE = {
    "student": {"model_name": str(DEMO / "vanilla")},
    "teacher": {"model_name": str(DEMO / "teacher")},
    # 2 docs a query: the plain keep-mask's Philox is most of a CPU step
    "training": {"learning_rate": 2e-3, "batch_size": 4, "epochs": 1, "num_docs_per_query": 2},
    "loss": {"in_batch_negatives": True},
    "mining": {"teacher_confidence_threshold": 0.0, "stage": 2, "bm25_top_k": 30},
}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs several workers on one
    machine, and more threads than cores slow every worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _inputs(root):
    raw = root / "raw" / "demo"
    raw.mkdir(parents=True)
    for split in ("train", "validation"):
        lines = (DEMO / "data" / "raw" / "demo" / f"{split}.jsonl").read_text().splitlines()
        (raw / f"{split}.jsonl").write_text("\n".join(lines[:N_ROWS]) + "\n")
    return root


def _stale_cache(out_dir):
    out_dir.mkdir(parents=True)
    stale = [{"doc_ids": ["no_such_passage"], "scores": [0.0]}] * N_ROWS
    (out_dir / "mined_stage2.json").write_text(json.dumps(stale))


def _finite(result):
    losses = [v for rec in result["history"] for k, v in rec.items()
              if isinstance(v, float) and ("loss" in k or k in ("margin_mse", "listwise_kd",
                                                                "contrastive"))]
    assert losses and all(math.isfinite(v) for v in losses)


def test_pipeline_mines_what_the_jax_pipeline_mines(tmp_path, monkeypatch):
    for side in ("j", "t"):
        _inputs(tmp_path / side)
        _stale_cache(tmp_path / side / "run")
    monkeypatch.setattr(JKDTrainer, "train", lambda self, *a, **kw: {"history": []})
    j_pipeline.run_train_pipeline(JSettings.model_validate(RECIPE), data_dir=tmp_path / "j",
                                  output_dir=tmp_path / "j" / "run", dataset="demo")
    result = t_pipeline.run_train_pipeline(Settings.from_dict(RECIPE), data_dir=tmp_path / "t",
                                           output_dir=tmp_path / "t" / "run", dataset="demo",
                                           device="cpu")
    want = json.loads((tmp_path / "j" / "run" / "mined_stage2.json").read_text())
    got = json.loads((tmp_path / "t" / "run" / "mined_stage2.json").read_text())
    assert len(got) == len(want) == N_ROWS == result["num_queries"]
    assert all(m["doc_ids"] != ["no_such_passage"] for m in got + want)  # both re-mined
    for g, w in zip(got, want):
        assert g["doc_ids"] == w["doc_ids"]
        s, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
        assert (np.abs(s - ws) / (1 + np.abs(ws))).max() <= 1e-5
    assert sum(len(m["doc_ids"]) for m in got) >= 5 * N_ROWS
    # the chunk files of step 2 and the BM25 index of step 3
    for split in ("train", "validation"):
        j_rows = pd.read_parquet(tmp_path / "j" / "chunks" / "demo" / f"{split}.parquet")
        t_rows = read_parquet(tmp_path / "t" / "chunks" / "demo" / f"{split}.parquet")
        for col in ("chunk_id", "doc_id", "text", "tokens", "is_relevant"):
            assert t_rows[col] == j_rows[col].tolist()
    assert (json.loads((tmp_path / "t" / "bm25" / "demo" / "doc_ids.json").read_text())
            == json.loads((tmp_path / "j" / "bm25" / "demo" / "doc_ids.json").read_text()))
    _finite(result)
    assert result["global_step"] > 0 and result["corpus_size"] > N_ROWS
    best = StudentModel(str(tmp_path / "t" / "run" / "best_model"), device="cpu")
    assert best.encode_queries(["what is river"]).shape == (1, 128)
    # a valid cache is reused as it is
    cached = t_pipeline._load_mined_cache(tmp_path / "t" / "run" / "mined_stage2.json",
                                          ["q"] * N_ROWS, {d: "" for m in got
                                                           for d in m["doc_ids"]})
    assert [m.doc_ids for m in cached] == [m["doc_ids"] for m in got]


def test_tiny_pipeline_runs_stage_3_on_generated_data(tmp_path):
    """``train --tiny``'s models (BertConfig.tiny for both, head dim 16) with
    the corpus-fitted vocabulary, on 24 generated demo rows: stage 3 mines a
    union of at most 5 teacher ids and the ANCE picks, the refresher runs
    at the epoch boundary, every loss is finite, the init snapshot saves.
    (The student's attention dropout is 0 here: on the CPU the plain
    keep-mask's Philox would be most of the run; the card runs the --tiny
    defaults, dropout included, in chip_smoke's pipeline phase.)"""
    settings = Settings.from_dict({
        "training": {"batch_size": 8, "epochs": 2, "learning_rate": 1e-3,
                     "num_docs_per_query": 4},
        "mining": {"teacher_confidence_threshold": 0.0, "bm25_top_k": 20,
                   "ance_refresh_every_n_steps": 1, "ance_margin": 1.0},
        "teacher": {"batch_size": 64},
    })
    result = t_pipeline.run_train_pipeline(
        settings, data_dir=tmp_path / "data", output_dir=tmp_path / "run", dataset="demo",
        max_samples=24, stage=3, student_config=BertConfig.tiny(attention_dropout=0.0),
        teacher_config=BertConfig.tiny(), save_init_to=tmp_path / "init", device="cpu")
    mined = json.loads((tmp_path / "run" / "mined_stage3.json").read_text())
    assert len(mined) == result["num_queries"] > 0
    assert sum(1 for m in mined if m["doc_ids"]) > len(mined) // 2
    for m in mined:
        assert len(m["doc_ids"]) == len(set(m["doc_ids"])) <= 5 + settings.mining.ance_top_k
    assert (tmp_path / "data" / "chunks" / "demo" / "train.parquet").exists()
    _finite(result)
    init = StudentModel(str(tmp_path / "init"), device="cpu")
    assert init.config.hidden_size // init.config.num_heads == 16
    assert init.tokenizer.vocab_size <= 2048


def test_pipeline_refuses_what_the_port_does_not_do(tmp_path, monkeypatch):
    settings = Settings.from_dict(RECIPE)
    # a missing non-demo raw split is fetched from the hub (data/fetch.py);
    # a `datasets` whose download fails stands in for a host without a
    # network, so that no test reaches for one
    offline = types.ModuleType("datasets")

    def load_dataset(*args, **kwargs):
        raise ConnectionError("no network")

    offline.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", offline)
    with pytest.raises(DataError, match="cannot download ms_marco"):
        t_pipeline.run_train_pipeline(settings, data_dir=tmp_path, dataset="msmarco",
                                      device="cpu")
    # data parallelism is ported: a mesh whose data axis this run's one
    # process does not make up is refused before any work
    mesh = create_mesh(data_parallel=2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ConfigError, match="mesh axis 'data' has 2 entries"):
        t_pipeline.run_train_pipeline(settings, data_dir=tmp_path, mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipeline.run_train_pipeline(settings, data_dir=_inputs(tmp_path / "c"))
