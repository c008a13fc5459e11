"""Port vs JAX: the on-disk index layout, both directions, and search."""

import json

import numpy as np
import pytest

from sskd_tpu.exceptions import IndexBuildError as JIndexBuildError
from sskd_tpu.exceptions import IndexLoadError as JIndexLoadError
from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu_torch.exceptions import IndexBuildError, IndexLoadError
from sskd_tpu_torch.index.builder import IndexBuilder

NB_INDEX = "artifacts/nb_index"


def _queries(seed, n, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _search_both(jb, tb, q, k):
    jv, ji = jb.search(q, k=k)
    tv, ti = tb.search(q, k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


def test_port_loads_nb_index_unchanged():
    tb = IndexBuilder(device="cpu").load(NB_INDEX)
    jb = JBuilder().load(NB_INDEX)
    assert (tb.ntotal, tb.dtype, tb.index_type, tb.embedding_dim) == (8000, "int8", "approx", 64)
    assert tb.doc_ids == jb.doc_ids
    np.testing.assert_array_equal(tb._vectors, jb._vectors)
    # searched as it is recorded: 8,000 rows are 63 bins, below the approx
    # engines' reduction on both sides, so the ids are the exact ones
    _search_both(jb, tb, _queries(0, 3, 64), k=10)
    assert tb.index_type == jb.index_type == "approx"
    tb.index_type = jb.index_type = "exact"
    _search_both(jb, tb, _queries(0, 3, 64), k=10)


def test_port_rejects_corrupt_index(tmp_path):
    tb = IndexBuilder(embedding_dim=16, dtype="int8", device="cpu")
    tb.build_from_arrays(_queries(1, 50, 16), [f"d{i}" for i in range(50)])
    tb.save(tmp_path / "idx")
    meta = json.loads((tmp_path / "idx" / "meta.json").read_text())
    meta["checksums"]["vectors"] = "0" * 64
    (tmp_path / "idx" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(IndexLoadError, match="checksum"):
        IndexBuilder(device="cpu").load(tmp_path / "idx")
    with pytest.raises(JIndexLoadError, match="checksum"):
        JBuilder().load(tmp_path / "idx")


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_jax_loads_what_the_port_saved(tmp_path, dtype):
    emb = _queries(2, 700, 64) * 3.0  # unnormalized: the builders normalize
    ids = [f"doc-{i}" for i in range(700)]
    texts = [f"text {i}" for i in range(700)]
    tb = IndexBuilder(embedding_dim=64, dtype=dtype, device="cpu")
    tb.build_from_arrays(emb, ids, texts=texts)
    tb.save(tmp_path / "idx")
    jb = JBuilder().load(tmp_path / "idx")
    ref = JBuilder(embedding_dim=64, dtype=dtype).build_from_arrays(emb, ids, texts=texts)
    np.testing.assert_array_equal(jb._vectors, ref._vectors)  # same bytes as a JAX build
    assert jb.doc_ids == ids and jb.texts == texts and jb.index_type == "exact"
    _search_both(jb, tb, _queries(3, 4, 64), k=20)


def test_validate_gate():
    tb = IndexBuilder(embedding_dim=64, dtype="int8", device="cpu")
    tb.build_from_arrays(_queries(4, 2000, 64), [str(i) for i in range(2000)])
    report = tb.validate(n_queries=50)
    assert report["recall@10"] >= 0.97 and report["n_queries"] == 50.0


def test_unported_builds_raise():
    """bf16 rows and refine rows are built now (tests/test_torch_refine.py
    holds them to JAX); what the JAX builder refuses, the port refuses too."""
    x = _queries(7, 300, 8)
    bf = IndexBuilder(embedding_dim=8, dtype="bfloat16", device="cpu").build_from_arrays(
        x, [str(i) for i in range(300)]
    )
    assert bf._vectors.dtype == np.uint16 and bf._refine is None
    ref = IndexBuilder(embedding_dim=8, dtype="int8", refine_m=4, device="cpu")
    ref.build_from_arrays(x, [str(i) for i in range(300)])
    assert ref._refine.shape == (300, 8) and ref.refine_m == 4
    for kw in (dict(dtype="int4", index_type="clustered"), dict(refine_storage="disk"),
               dict(dtype="float16")):
        with pytest.raises(IndexBuildError):
            IndexBuilder(embedding_dim=8, device="cpu", **kw)
        with pytest.raises(JIndexBuildError):
            JBuilder(embedding_dim=8, **kw)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_approx_index_both_directions(tmp_path, dtype):
    """An approx index saved by either package is loaded and searched by the
    other; validate() passes the configs/index.yaml gate."""
    emb = _queries(5, 900, 64)
    ids = [f"doc-{i}" for i in range(900)]
    tb = IndexBuilder(embedding_dim=64, index_type="approx", dtype=dtype, recall_target=0.95,
                      device="cpu").build_from_arrays(emb, ids)
    jb = JBuilder(embedding_dim=64, index_type="approx", dtype=dtype,
                  recall_target=0.95).build_from_arrays(emb, ids)
    tb.save(tmp_path / "torch")
    jb.save(tmp_path / "jax")
    for name in ("vectors.npy", "meta.json", "doc_ids.json"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    j_from_t = JBuilder().load(tmp_path / "torch")
    t_from_j = IndexBuilder(device="cpu").load(tmp_path / "jax")
    assert t_from_j.index_type == j_from_t.index_type == "approx"
    assert t_from_j.recall_target == j_from_t.recall_target == 0.95
    _search_both(j_from_t, t_from_j, _queries(6, 5, 64), k=10)
    assert t_from_j.validate(n_queries=40)["recall@10"] >= 0.97
