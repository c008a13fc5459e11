"""The port's command line, run in process with ``--platform cpu``, against
the JAX package's: demo-data, prepare and integrity print the same JSON and
write the same raw files; config prints the JAX tree and the same audit;
compare over the repository's demo checkpoints gives the JAX verdict
(FAILED, exit 1) with every number within 1e-3 of the JAX command's; index
build / validate, export and doctor run end to end; what is not ported
exits nonzero with a message."""

import json
import logging
import re
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from sskd_tpu.cli.main import main as j_main
from sskd_tpu.config import get_settings as j_get_settings
from sskd_tpu.config import reset_settings_cache
from sskd_tpu_torch.cli.main import main
from sskd_tpu_torch.data.parquet import read_parquet
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel

ROOT = Path(__file__).resolve().parent.parent
DEMO = ROOT / "artifacts" / "demo"
CPU = ["--platform", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _port_logging_restored():
    """``main`` configures the port's logging as a command does (its own
    handlers on the stream of the test that ran it, no propagation); later
    test files in this process get the logging they would have had without
    this one (a caplog there sees the port's records again)."""
    yield
    from sskd_tpu_torch.utils import logging as port_logging

    port_logging._stop_listener()
    logger = logging.getLogger("sskd_tpu_torch")
    logger.handlers.clear()
    logger.propagate = True
    logger.setLevel(logging.NOTSET)
    port_logging._CONFIGURED = False


def _run(fn, argv, capsys):
    rc = fn(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """The same relative data dir, made by each CLI in a directory of its own."""
    return tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")


@pytest.mark.parametrize("argv", [
    ["demo-data", "--out", "d/raw/demo", "--samples", "24", "--splits",
     "train=0.7,validation=0.15,test=0.15"],
    ["prepare", "--data-dir", "d", "--dataset", "demo", "--max-tokens", "64", "--stride", "16"],
    ["integrity", "--data-dir", "d", "--dataset", "demo"],
], ids=lambda a: a[0])
def test_data_commands_print_what_jax_prints(workspaces, monkeypatch, capsys, argv):
    port_dir, jax_dir = workspaces
    monkeypatch.chdir(port_dir)
    rc, out = _run(main, argv + CPU, capsys)
    monkeypatch.chdir(jax_dir)
    j_rc, j_out = _run(j_main, argv + CPU, capsys)
    assert rc == j_rc == 0
    assert json.loads(out) == json.loads(j_out)
    if argv[0] == "demo-data":
        for name in ("train.jsonl", "validation.jsonl", "test.jsonl", "test.qrels.jsonl"):
            assert (port_dir / "d/raw/demo" / name).read_bytes() == \
                (jax_dir / "d/raw/demo" / name).read_bytes()


def test_integrity_fails_as_jax_does(workspaces, monkeypatch, capsys):
    port_dir, _ = workspaces
    monkeypatch.chdir(port_dir)
    shutil.copytree("d", "bad")
    raw = Path("bad/raw/demo/train.jsonl")
    raw.write_text("".join(raw.read_text().splitlines(keepends=True)[:-1]))  # a row lost
    argv = ["integrity", "--data-dir", "bad", "--dataset", "demo"] + CPU
    rc, out = _run(main, argv, capsys)
    j_rc, j_out = _run(j_main, argv, capsys)
    assert rc == j_rc == 1 and json.loads(out) == json.loads(j_out)
    assert json.loads(out)["ok"] is False


@pytest.mark.parametrize("audit", [False, True])
def test_config_prints_the_jax_tree(monkeypatch, capsys, audit):
    monkeypatch.setenv("SEMANTIC_KD_CONFIG_PATH", str(ROOT / "configs" / "service.yaml"))
    monkeypatch.setenv("SEMANTIC_KD_CACHE__ENABLED", "true")
    reset_settings_cache()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = j_get_settings()
    finally:
        reset_settings_cache()
    rc, out = _run(main, ["config"] + (["--production-audit"] if audit else []) + CPU, capsys)
    decoder = json.JSONDecoder()
    tree, end = decoder.raw_decode(out)
    assert tree == want.model_dump(mode="json")
    if audit:
        assert rc == 1
        assert json.loads(out[end:]) == {"production_problems": want.validate_for_production()}
    else:
        assert rc == 0 and not out[end:].strip()


def _table(report: str) -> dict:
    lines = [ln for ln in report.splitlines() if ln.startswith("| ")]
    head = [c.strip() for c in lines[0].strip("|").split("|")]
    return {cells[0]: dict(zip(head[1:], map(float, cells[1:])))
            for cells in ([c.strip() for c in ln.strip("|").split("|")] for ln in lines[1:])}


def test_compare_gives_the_jax_verdict(capsys):
    argv = ["compare", "--kd-model", str(DEMO / "run_kd/best_model"),
            "--vanilla-model", str(DEMO / "vanilla"), "--teacher-model", str(DEMO / "teacher"),
            "--data", str(DEMO / "data/raw/demo/test.jsonl"), "--max-samples", "24"] + CPU
    rc, out = _run(main, argv, capsys)
    j_rc, j_out = _run(j_main, argv, capsys)
    assert rc == j_rc == 1
    assert "**FAILED**" in out and "**FAILED**" in j_out
    got, want = _table(out), _table(j_out)
    assert list(got) == list(want) == ["kd_student", "vanilla", "teacher"]
    for name in want:  # the report prints 4 decimals
        assert max(abs(got[name][m] - want[name][m]) for m in want[name]) <= 1e-3, name
    gate = re.compile(r"nDCG@10 = ([0-9.]+)")
    assert abs(float(gate.search(out)[1]) - float(gate.search(j_out)[1])) <= 1e-3


@pytest.fixture(scope="module")
def flow(workspaces, tmp_path_factory):
    """A tiny student saved in the port's format, over the port's prepared data."""
    port_dir, _ = workspaces
    root = tmp_path_factory.mktemp("flow")
    student = StudentModel("tiny-cli", device="cpu", config=BertConfig.tiny(), seed=3)
    student.save(root / "student")
    return root, port_dir / "d/chunks/demo/train.parquet"


def test_index_build_validate_doctor_and_export(flow, capsys):
    root, parquet = flow
    argv = ["index", "build", "--model", str(root / "student"), "--data", str(parquet),
            "--out", str(root / "idx"), "--dtype", "int8", "--method", "exact"] + CPU
    rc, out = _run(main, argv, capsys)
    cols = read_parquet(parquet, ["chunk_id", "text"])
    n = len(cols["text"])
    assert rc == 0 and json.loads(out) == {"ntotal": n, "out": str(root / "idx")}
    # the rows equal an in-process build with the same student, bit for bit
    student = StudentModel(str(root / "student"), device="cpu")
    want = IndexBuilder(64, index_type="exact", dtype="int8", device="cpu").build_from_arrays(
        student.encode_documents(cols["text"]), cols["chunk_id"], texts=cols["text"])
    got = IndexBuilder(device="cpu").load(root / "idx")
    assert np.array_equal(got._vectors, want._vectors)
    assert np.array_equal(got._scales, want._scales) and got.doc_ids == want.doc_ids

    rc, out = _run(main, ["index", "validate", "--dir", str(root / "idx"), "--queries", "50"]
                   + CPU, capsys)
    assert rc == 0 and json.loads(out)["passed"] is True
    rc, out = _run(main, ["index", "validate", "--dir", str(root / "idx"), "--queries", "50",
                          "--min-recall", "1.01"] + CPU, capsys)
    assert rc == 1 and json.loads(out)["passed"] is False

    rc, out = _run(main, ["doctor", "--index", str(root / "idx")] + CPU, capsys)
    report = json.loads(out)
    assert rc == 0 and report["ok"], report
    assert report["required"] == ["cuda_device", "native_tokenizer", "dependencies", "index"]
    assert report["checks"]["cuda_device"]["device"] == "cpu"
    assert report["checks"]["index"]["ntotal"] == n

    rc, out = _run(main, ["export", "--model", str(root / "student"), "--out",
                          str(root / "export")] + CPU, capsys)
    report = json.loads(out)
    assert rc == 0 and report["validation_passed"] and report["validation_min_cosine"] >= 0.99
    assert (root / "export" / "weights_int8.npz").exists()


@pytest.mark.parametrize("argv,says", [
    # sharded serving is ported; a mesh the devices cannot hold (one CPU
    # entry without --cpu-devices) exits before the server starts
    (["serve", "--shards", "2"] + CPU, "must divide device count 1"),
    # data-parallel training is ported: on CUDA it needs a card a process
    # (the test makes the machine hold one), checked before any work
    (["train", "--data-parallel", "2"], "this machine has 1"),
    # --cpu-devices runs on the CPU: it cannot go with another platform
    (["config", "--cpu-devices", "8", "--platform", "cuda"], "--cpu-devices"),
    (["config", "--platform", "tpu"], "tpu"),
], ids=["shards", "data-parallel", "cpu-devices", "tpu"])
def test_what_is_not_ported_exits_nonzero(monkeypatch, capsys, argv, says):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = main(argv)
    err = capsys.readouterr().err
    assert rc == 2 and "error" in err and says in err


@pytest.mark.parametrize("argv", [["config"], ["eval", "--model", "m", "--data", "d"]])
def test_missing_cuda_exits_nonzero(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SSKD_PLATFORM", raising=False)
    assert main(argv) == 2
    assert "CUDA" in capsys.readouterr().err
    # the doctor reports the missing device instead, and fails
    rc = main(["doctor"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and not report["checks"]["cuda_device"]["ok"]
