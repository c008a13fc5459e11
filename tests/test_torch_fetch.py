"""Port vs JAX: ``data/fetch.py``.

No test reaches the network: a stub ``datasets`` module in ``sys.modules``
serves seeded MS MARCO v2.1 rows (or fails its download, or is missing),
and both packages' ``fetch_msmarco`` run under it. Held: the per-split
JSONL files are byte for byte equal, the manifests and return values equal
up to the data directory, the same ``load_dataset`` calls, and the same
``DataError`` (message and details) where the JAX package raises one; the
port's ``run_train_pipeline`` reaches the fetch for a missing non-demo raw
split."""

import json
import sys
import types

import numpy as np
import pytest

from sskd_tpu.data import fetch as j_fetch
from sskd_tpu.exceptions import DataError as JDataError
from sskd_tpu_torch.cli import pipeline as t_pipeline
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.data import fetch as t_fetch
from sskd_tpu_torch.exceptions import DataError

WORDS = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()


def _rows(split: str, n: int) -> list[dict]:
    """Seeded rows in the ms_marco v2.1 layout."""
    rng = np.random.default_rng(len(split))
    rows = []
    for i in range(n):
        texts = [" ".join(rng.choice(WORDS, 6)) for _ in range(3)]
        rows.append({
            "answers": [texts[0]], "query": " ".join(rng.choice(WORDS, 3)),
            "query_id": int(1000 * len(split) + i), "query_type": "description",
            "passages": {"is_selected": [1, 0, 0], "passage_text": texts,
                         "url": [f"http://example.org/{i}/{j}" for j in range(3)]},
            "wellFormedAnswers": [],
        })
    return rows


class _Split:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def select(self, indices):
        return _Split([self.rows[i] for i in indices])


def _stub(monkeypatch, fail: Exception | None = None) -> list:
    """Put a ``datasets`` in ``sys.modules`` whose ``load_dataset`` serves
    the seeded rows (or raises ``fail``); returns its calls."""
    calls = []
    mod = types.ModuleType("datasets")

    def load_dataset(name, config, split):
        calls.append((name, config, split))
        if fail is not None:
            raise fail
        return _Split(_rows(split, 7))

    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)
    return calls


def _relative(obj, root):
    """``obj`` (a manifest) with ``root``'s path cut from every string."""
    return json.loads(json.dumps(obj).replace(str(root), "<data>"))


@pytest.mark.parametrize("max_samples", [None, 3])
def test_fetch_msmarco_writes_what_the_jax_package_writes(tmp_path, monkeypatch, max_samples):
    calls = _stub(monkeypatch)
    want = j_fetch.fetch_msmarco(tmp_path / "jax", max_samples=max_samples)
    got = t_fetch.fetch_msmarco(tmp_path / "port", max_samples=max_samples)
    assert calls[:2] == calls[2:] == [("ms_marco", "v2.1", "train"),
                                      ("ms_marco", "v2.1", "validation")]
    assert _relative(got, tmp_path / "port") == _relative(want, tmp_path / "jax")
    assert got["splits"]["train"]["num_samples"] == (max_samples or 7)
    for split in ("train", "validation"):
        rel = f"raw/msmarco/{split}.jsonl"
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    manifests = [json.loads(p.read_text()) for p in
                 (tmp_path / "port" / "raw" / "msmarco" / "_manifest.json",
                  tmp_path / "jax" / "raw" / "msmarco" / "_manifest.json")]
    assert _relative(manifests[0], tmp_path / "port") == _relative(manifests[1], tmp_path / "jax")


@pytest.mark.parametrize("case", ["download fails", "datasets missing"])
def test_fetch_msmarco_raises_where_the_jax_package_raises(tmp_path, monkeypatch, case):
    if case == "download fails":
        _stub(monkeypatch, fail=ConnectionError("no route to the hub"))
    else:
        monkeypatch.setitem(sys.modules, "datasets", None)  # the import fails
    with pytest.raises(JDataError) as want:
        j_fetch.fetch_msmarco(tmp_path / "jax")
    with pytest.raises(DataError) as got:
        t_fetch.fetch_msmarco(tmp_path / "port")
    assert (got.value.message, got.value.details) == (want.value.message, want.value.details)
    assert not (tmp_path / "port" / "raw" / "msmarco" / "_manifest.json").exists()


def test_fetch_all_datasets_and_the_beir_stub(tmp_path, monkeypatch):
    _stub(monkeypatch)
    want = j_fetch.fetch_all_datasets(tmp_path / "jax", max_samples=2)
    got = t_fetch.fetch_all_datasets(tmp_path / "port", max_samples=2)
    assert _relative(got, tmp_path / "port") == _relative(want, tmp_path / "jax")
    assert got["scifact"] == {"dataset": "scifact", "splits": {}, "skipped": True}


class _Stop(Exception):
    pass


def test_the_pipeline_fetches_a_missing_non_demo_split(tmp_path, monkeypatch):
    """Step [1/7] of run_train_pipeline fetches MS MARCO for a missing raw
    split, as the JAX package's does; the run is stopped at step [2/7]."""
    import sskd_tpu_torch.data.prepare as t_prepare

    _stub(monkeypatch)

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(t_prepare, "prepare_dataset", stop)
    with pytest.raises(_Stop):
        t_pipeline.run_train_pipeline(Settings(), data_dir=tmp_path / "port",
                                      dataset="msmarco", max_samples=4, device="cpu")
    j_fetch.fetch_msmarco(tmp_path / "jax", max_samples=4)
    rel = "raw/msmarco/train.jsonl"
    assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
