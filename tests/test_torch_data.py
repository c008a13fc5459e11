"""Port vs JAX: the data slice (registry, demo generator, parquet route,
preparation, integrity).

- ``generate_demo_dataset`` writes byte-identical files to the JAX one's.
- ``data/parquet.py`` (the port's pure-Python parquet reader and writer:
  the machine with the GPU has no pandas or pyarrow) reads the repository's
  four chunk files equal to ``pandas.read_parquet``, column by column and
  row by row; pandas reads what it writes as written; pyarrow's other
  layouts of the subset (data pages v2, PLAIN without a dictionary,
  UNCOMPRESSED, several pages and row groups, nulls) read back; anything
  outside the subset raises ``DataError`` naming it.
- ``prepare_dataset`` writes what the JAX one writes from the same raw
  split, in every column but ``updated_at`` (MS MARCO layout and BEIR).
- ``check_dataset_integrity`` returns the JAX package's problem lists on
  clean, truncated, duplicated, empty-text and missing-file fixtures.
"""

import json
import shutil

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from sskd_tpu.data import integrity as j_integrity
from sskd_tpu.data import prepare as j_prepare
from sskd_tpu.data.demo import generate_demo_dataset as j_generate
from sskd_tpu.data.registry import DATASETS as J_DATASETS
from sskd_tpu_torch.data import integrity as t_integrity
from sskd_tpu_torch.data import prepare as t_prepare
from sskd_tpu_torch.data import registry as t_registry
from sskd_tpu_torch.data.demo import generate_demo_dataset as t_generate
from sskd_tpu_torch.data.parquet import (
    parquet_columns,
    read_parquet,
    snappy_compress,
    snappy_decompress,
    write_parquet,
)
from sskd_tpu_torch.exceptions import DataError, DataIntegrityError, DatasetNotFoundError

REPO_PARQUET = ["data/chunks/demo/train.parquet", "data/chunks/demo/validation.parquet",
                "artifacts/demo/data/chunks/demo/train.parquet",
                "artifacts/demo/data/chunks/demo/validation.parquet"]


def _pandas_rows(df: pd.DataFrame) -> dict:
    """A DataFrame as {column: [values]} with pandas' missing values as None
    and integral floats (an int column with nulls) as int."""
    out = {}
    for c in df.columns:
        vals = []
        for v in df[c].tolist():
            if v is None or (isinstance(v, float) and np.isnan(v)):
                vals.append(None)
            elif isinstance(v, float) and v.is_integer():
                vals.append(int(v))
            else:
                vals.append(v)
        out[c] = vals
    return out


def test_registry_matches_jax(tmp_path):
    assert {n: (c.source, c.splits) for n, c in t_registry.DATASETS.items()} == {
        n: (c.source, c.splits) for n, c in J_DATASETS.items()}
    assert t_registry.get_chunks_path(tmp_path, "demo", "train") == (
        tmp_path / "chunks" / "demo" / "train.parquet")
    assert t_registry.is_beir_dataset("fiqa") and not t_registry.is_beir_dataset("demo")
    with pytest.raises(DatasetNotFoundError):
        t_registry.get_dataset_config("nope")


@pytest.mark.parametrize("seed,num_samples,splits,fractions", [
    (42, 48, ("train", "validation"), (0.8, 0.2)),
    (7, 60, ("train", "validation", "test"), (0.7, 0.15, 0.15)),
])
def test_demo_dataset_is_byte_identical_to_jax(tmp_path, seed, num_samples, splits, fractions):
    j_man = j_generate(tmp_path / "j", num_samples=num_samples, seed=seed, splits=splits,
                       split_fractions=fractions)
    t_man = t_generate(tmp_path / "t", num_samples=num_samples, seed=seed, splits=splits,
                       split_fractions=fractions)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert any(n.endswith(".qrels.jsonl") for n in names)
    for name in names:
        if name == "_manifest.json":
            continue  # holds the output paths
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    assert json.dumps(j_man).replace(str(tmp_path / "j"), "") == json.dumps(t_man).replace(
        str(tmp_path / "t"), "")


@pytest.mark.parametrize("path", REPO_PARQUET)
def test_reader_reads_the_repository_chunk_files_as_pandas(path):
    """pyarrow 25's files: one row group, SNAPPY, PLAIN / RLE /
    RLE_DICTIONARY, UTF8 and INT64 columns."""
    want = pd.read_parquet(path)
    got = read_parquet(path)
    assert list(got) == list(want.columns) == parquet_columns(path)
    assert got == _pandas_rows(want)
    some = read_parquet(path, columns=["text", "chunk_id"])
    assert list(some) == ["text", "chunk_id"] and some["text"] == got["text"]


def test_pandas_reads_what_the_writer_writes(tmp_path):
    cols = {
        "s": ["a", None, "héllo wörld", "", *(f"w{i}" for i in range(300))],
        "i": [1, None, -3, 2**40, *range(300)],
        "n": [None] * 304,
    }
    path = write_parquet(tmp_path / "x.parquet", cols)
    assert _pandas_rows(pd.read_parquet(path)) == cols
    assert read_parquet(path) == cols
    assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression == "SNAPPY"
    empty = write_parquet(tmp_path / "e.parquet", {"a": [], "b": []})
    assert read_parquet(empty) == {"a": [], "b": []} and len(pd.read_parquet(empty)) == 0


@pytest.mark.parametrize("kw", [
    {"compression": "none"}, {"data_page_version": "2.0"}, {"use_dictionary": False},
    {"data_page_version": "2.0", "compression": "none", "use_dictionary": False},
    {"data_page_size": 64}, {"row_group_size": 7},
], ids=["uncompressed", "v2", "plain", "v2-plain-uncompressed", "pages", "row-groups"])
def test_reader_takes_the_subset_in_each_layout(tmp_path, kw):
    table = pa.table({"s": pa.array(["a", None, "bb"] * 40),
                      "i": pa.array([1, 2, None] * 40, pa.int64())})
    pq.write_table(table, tmp_path / "v.parquet", **kw)
    assert read_parquet(tmp_path / "v.parquet") == {"s": table["s"].to_pylist(),
                                                    "i": table["i"].to_pylist()}


@pytest.mark.parametrize("table,kw,named", [
    (pa.table({"s": ["a"]}), {"compression": "gzip"}, "GZIP"),
    (pa.table({"s": ["a"]}), {"compression": "zstd"}, "ZSTD"),
    (pa.table({"n": pa.array([{"x": 1}])}), {}, "nested"),
    (pa.table({"f": pa.array([1.5])}), {}, "DOUBLE"),
    (pa.table({"l": pa.array([[1, 2]])}), {}, "nested"),
    (pa.table({"b": pa.array([b"\x00"], pa.binary())}), {}, "UTF8"),
])
def test_reader_refuses_what_lies_outside_the_subset(tmp_path, table, kw, named):
    pq.write_table(table, tmp_path / "o.parquet", **kw)
    with pytest.raises(DataError, match=named):
        read_parquet(tmp_path / "o.parquet")


def test_reader_refuses_other_files_and_columns(tmp_path):
    (tmp_path / "x.parquet").write_bytes(b"not a parquet file")
    with pytest.raises(DataError, match="PAR1"):
        read_parquet(tmp_path / "x.parquet")
    with pytest.raises(DataError, match="no column"):
        read_parquet(REPO_PARQUET[1], columns=["nope"])
    with pytest.raises(DataError):
        write_parquet(tmp_path / "y.parquet", {"a": [1.5]})
    with pytest.raises(DataError):
        write_parquet(tmp_path / "y.parquet", {"a": [1], "b": [1, 2]})


def test_snappy_round_trip_and_back_references():
    data = bytes(range(256)) * 300 + b"x" * 70000
    assert snappy_decompress(snappy_compress(data)) == data
    # a hand-made stream: literal "abcd", then a 2-byte-offset copy of 10 bytes
    # at offset 4 (overlapping: the pattern repeats), then a 1-byte-offset copy
    stream = bytes([18, 3 << 2]) + b"abcd" + bytes([(9 << 2) | 2, 4, 0]) + bytes(
        [(0 << 2) | 1, 14])
    assert snappy_decompress(stream) == b"abcd" + b"abcdabcdab" + b"abcd"
    with pytest.raises(DataError):
        snappy_decompress(bytes([5, 0]) + b"a")


def _raw_demo(tmp_path, n=24):
    raw = tmp_path / "raw" / "demo"
    j_generate(raw, num_samples=n, seed=5)
    return tmp_path


def test_prepare_dataset_matches_jax(tmp_path):
    for side in ("j", "t"):
        _raw_demo(tmp_path / side)
    j_man = j_prepare.prepare_dataset(tmp_path / "j", dataset="demo", max_tokens=24, stride=4)
    t_man = t_prepare.prepare_dataset(tmp_path / "t", dataset="demo", max_tokens=24, stride=4)
    for split in ("train", "validation"):
        want = pd.read_parquet(tmp_path / "j" / "chunks" / "demo" / f"{split}.parquet")
        path = tmp_path / "t" / "chunks" / "demo" / f"{split}.parquet"
        got = read_parquet(path)
        assert list(got) == list(t_prepare.REQUIRED_COLUMNS) == list(want.columns)
        want_rows = _pandas_rows(want)
        assert len(got["chunk_id"]) > len(set(got["doc_id"]))  # long passages were chunked
        for col in got:
            if col != "updated_at":
                assert got[col] == want_rows[col], col
        # and the JAX package reads the port's file as its own
        assert _pandas_rows(pd.read_parquet(path)) == got
        assert t_man["splits"][split]["num_chunks"] == j_man["splits"][split]["num_chunks"]
    j_prepare.prepare_dataset(tmp_path / "j", dataset="demo")
    t_prepare.prepare_dataset(tmp_path / "t", dataset="demo")
    assert read_parquet(tmp_path / "t" / "chunks" / "demo" / "train.parquet",
                        columns=["chunk_id"]) == {"chunk_id": pd.read_parquet(
        tmp_path / "j" / "chunks" / "demo" / "train.parquet")["chunk_id"].tolist()}


def _beir(root):
    raw = root / "raw" / "scifact"
    (raw / "qrels").mkdir(parents=True)
    docs = [{"_id": "d1", "title": "Cats", "text": "cats sit " * 40},
            {"doc_id": "d2", "title": "", "text": "dogs bark at the mail"},
            {"_id": "", "text": "no id, skipped"},
            {"_id": "d3", "title": "Fish", "text": "fish swim"}]
    (raw / "corpus.jsonl").write_text(
        "\n".join(json.dumps(d) for d in docs) + "\nnot json\n")
    (raw / "queries.jsonl").write_text("\n".join(json.dumps(q) for q in (
        {"_id": "q1", "text": "where do cats sit"}, {"query_id": "q2", "text": "dog noise"},
        {"_id": "q3", "text": "unjudged"})) + "\n")
    (raw / "qrels" / "test.tsv").write_text("query-id\tcorpus-id\tscore\nq1\td1\t1\n"
                                            "q2\td2\t2\nq2\td3\tx\n")


def test_beir_preparation_and_eval_inputs_match_jax(tmp_path):
    for side in ("j", "t"):
        _beir(tmp_path / side)
    j_man = j_prepare.prepare_dataset(tmp_path / "j", dataset="scifact", max_tokens=32, stride=8)
    t_man = t_prepare.prepare_dataset(tmp_path / "t", dataset="scifact", max_tokens=32, stride=8)
    assert j_man["splits"]["corpus"]["num_chunks"] == t_man["splits"]["corpus"]["num_chunks"]
    jq, jchunks, jqrels = j_prepare.load_beir_eval(tmp_path / "j", "scifact")
    tq, tchunks, tqrels = t_prepare.load_beir_eval(tmp_path / "t", "scifact")
    assert (tq, tqrels) == (jq, jqrels)
    want = _pandas_rows(jchunks)
    assert list(tchunks) == list(want)
    for col in tchunks:
        if col != "updated_at":
            assert tchunks[col] == want[col], col
    assert j_integrity.check_dataset_integrity(tmp_path / "t", "scifact")["ok"]
    assert t_integrity.check_dataset_integrity(tmp_path / "j", "scifact")["ok"]


def _corrupt(root, how):
    chunks = root / "chunks" / "demo"
    if how == "truncated":
        raw = root / "raw" / "demo" / "validation.jsonl"
        raw.write_text("\n".join(raw.read_text().splitlines()[:-1]) + "\n")
    elif how == "duplicated":
        df = pd.read_parquet(chunks / "train.parquet")
        pd.concat([df, df.head(2), df.iloc[5:6]]).to_parquet(chunks / "train.parquet",
                                                               index=False)
    elif how == "empty-text":
        df = pd.read_parquet(chunks / "validation.parquet")
        df.loc[df.index[0], "text"] = ""
        df.to_parquet(chunks / "validation.parquet", index=False)
    elif how == "missing-file":
        (chunks / "train.parquet").unlink()
        (root / "raw" / "demo" / "_manifest.json").unlink()
    elif how == "missing-columns":
        df = pd.read_parquet(chunks / "train.parquet").drop(columns=["split", "tokens"])
        df.loc[df.index[1], "doc_id"] = None
        df.to_parquet(chunks / "train.parquet", index=False)


@pytest.mark.parametrize("how", ["clean", "truncated", "duplicated", "empty-text",
                                 "missing-file", "missing-columns"])
def test_integrity_reports_the_jax_problem_lists(tmp_path, how):
    root = _raw_demo(tmp_path, n=16)
    t_prepare.prepare_dataset(root, dataset="demo")
    _corrupt(root, how)
    want = j_integrity.check_dataset_integrity(root, "demo")
    got = t_integrity.check_dataset_integrity(root, "demo")
    assert got == want
    assert got["ok"] == (how == "clean")
    if how == "clean":
        t_integrity.require_integrity(root, "demo")
    else:
        with pytest.raises(DataIntegrityError) as err:
            t_integrity.require_integrity(root, "demo")
        assert err.value.details["problems"] == want["problems"]
    shutil.rmtree(root)


def test_file_hash_matches_jax(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(range(256)) * 5000)
    assert t_integrity.compute_file_hash(path) == j_integrity.compute_file_hash(path)
