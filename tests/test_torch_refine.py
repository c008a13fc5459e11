"""Port vs JAX: refined search (a quantized sweep, then a bf16 rescore) and
the indexes of bf16 rows, from the engine to the on-disk layout and the app.

The same seeded numpy inputs go to both packages; the port runs on the CPU,
where its kernel wrappers run their plain torch versions. On the CPU both
packages' candidate sweeps are exact at these sizes (4,096 rows are 32 tiles,
below the approx engines' reduction), so the candidates are equal and the
rescore decides. The rescore sums in another order than the JAX einsum:
scores within 1e-6, ids equal except where two scores lie within 1e-6.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sskd_tpu.exceptions import IndexLoadError as JIndexLoadError
from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.ops.topk import refined_topk_core as jrefined_topk_core
from sskd_tpu.serve.fused import FusedSearcher as JFused
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.exceptions import IndexBuildError, IndexLoadError
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.ops import topk as tt
from sskd_tpu_torch.ops import topk_kernels as tk
from sskd_tpu_torch.serve import app as app_module
from sskd_tpu_torch.serve.fused import FusedSearcher
from sskd_tpu_torch.serve.http import TestClient
from sskd_tpu_torch.tokenization import WordPieceTokenizer

TOL = 1e-6
N, D = 4096, 64


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _data(seed, n=N, b=8):
    rng = np.random.default_rng(seed)
    x = _normed(rng, n, D)
    q = x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal((b, D)).astype(np.float32)
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _assert_same_topk(tv, ti, jv, ji):
    """Scores within 1e-6; ids equal, except that an id in one result only
    scores within 1e-6 of that row's last score (a tie the order decides)."""
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    live = ji >= 0
    np.testing.assert_array_equal(ti >= 0, live)
    np.testing.assert_allclose(tv[live], jv[live], rtol=0, atol=TOL)
    for r in range(ti.shape[0]):
        if not np.array_equal(ti[r], ji[r]):
            for i in set(ti[r]) ^ set(ji[r]):
                v = tv[r][ti[r] == i] if i in ti[r] else jv[r][ji[r] == i]
                assert abs(float(v[0]) - float(jv[r][live[r]][-1])) <= TOL, (r, i)


def _storage(dtype, x):
    """(torch corpus, torch scales, JAX corpus, JAX scales, bf16 rows as
    torch and as ml_dtypes) of the JAX package's quantization."""
    from sskd_tpu.ops.quant import quantize_rows, quantize_rows_int4

    v, s = (quantize_rows if dtype == "int8" else quantize_rows_int4)(x)
    v, s = np.asarray(v), np.asarray(s)
    rb = x.astype(ml_dtypes.bfloat16)
    return (torch.from_numpy(v), torch.from_numpy(s), jnp.asarray(v), jnp.asarray(s),
            torch.from_numpy(rb.view(np.int16)).view(torch.bfloat16), jnp.asarray(rb))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("dtype,B,refine_m,n,k", [
    ("int8", 1, 16, N, 10), ("int8", 8, 40, N, 10), ("int4", 3, 40, N, 10),
    ("int4", 8, 16, N, 10),
    ("int8", 3, 5, N, 10),  # refine_m below k: clamped up to k
    ("int4", 3, 400, 300, 10),  # refine_m above N: clamped to N
    ("int8", 3, 40, 6, 10),  # fewer rows than k: -inf / -1 padding
])
def test_refined_topk_core_matches_jax(dtype, B, refine_m, n, k, precision):
    """The refined engine against the JAX package's refined_topk_core, also
    under torch.set_float32_matmul_precision("high") (which must not reach
    the rescore: it is an elementwise product and an f32 sum)."""
    x, q = _data(B * 100 + refine_m + n, n=n, b=B)
    tc, ts, jc, js, trb, jrb = _storage(dtype, x)
    jv, ji = jrefined_topk_core(jnp.asarray(q), jc, jrb, k, refine_m=refine_m, row_scales=js)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        tv, ti = tt.refined_topk(torch.from_numpy(q), tc, trb, k, refine_m=refine_m,
                                 row_scales=ts)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert tv.shape == (B, k) and ti.dtype == torch.int32
    _assert_same_topk(tv, ti, jv, ji)
    if n < k:
        assert (ti[:, n:] == -1).all() and (tv[:, n:] == tk.NEG_INF).all()


def test_rescore_is_the_bf16_rounded_query_against_widened_rows():
    """rescore_candidates: the query rounded to bf16, products and sums in
    f32, ties to the lower candidate slot, -1 candidates never returned."""
    x, q = _data(1, n=64, b=2)
    rows = torch.from_numpy(x).to(torch.bfloat16)
    cand = torch.tensor([[5, 9, 5, -1, 3], [-1, -1, 7, 7, 60]], dtype=torch.int32)
    vals, idx = tt.rescore_candidates(torch.from_numpy(q), rows, cand, 4)
    qb = torch.from_numpy(q).to(torch.bfloat16).double()
    for r in range(2):
        live = [(float(rows[c].double() @ qb[r]), s) for s, c in enumerate(cand[r].tolist())
                if c >= 0]
        order = sorted(live, key=lambda t: (-t[0], t[1]))[:4]
        want = [int(cand[r, s]) for _, s in order] + [-1] * (4 - len(order))
        assert idx[r].tolist() == want
        np.testing.assert_allclose(vals[r, :len(order)].numpy(), [v for v, _ in order],
                                   rtol=0, atol=TOL)
    assert vals[1, 3] == tk.NEG_INF


@pytest.mark.parametrize("m,k", [(40, 10), (6, 10)])
def test_host_rescore_matches_jax(m, k):
    """IndexBuilder._host_rescore against the JAX package's, on the same
    refine rows and candidates (-1 slots, and m < k padded with -inf / -1)."""
    x, q = _data(2, n=500, b=4)
    ids = [str(i) for i in range(500)]
    tb = IndexBuilder(D, dtype="int8", refine_m=40, device="cpu").build_from_arrays(x, ids)
    jb = JBuilder(D, dtype="int8", refine_m=40).build_from_arrays(x, ids)
    np.testing.assert_array_equal(tb._refine, jb._refine.view(np.uint16))
    rng = np.random.default_rng(m)
    cand = rng.integers(0, 500, (4, m)).astype(np.int32)
    cand[:, -2:] = -1
    tv, ti = tb._host_rescore(q, cand, k)
    jv, ji = jb._host_rescore(q, cand, k)
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and tv.shape == (4, k)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    _assert_same_topk(np.where(np.isfinite(tv), tv, tk.NEG_INF), ti,
                      np.where(np.isfinite(jv), jv, tk.NEG_INF), ji)


# ---------------------------------------------------------------------------
# Indexes (a) to (e), saved by either package, loaded and searched by the other
# ---------------------------------------------------------------------------

CASES = {
    "a": dict(dtype="int8", index_type="approx", refine_m=40),
    "b": dict(dtype="int4", index_type="exact", refine_m=40),
    "c": dict(dtype="bfloat16", index_type="exact"),
    "d": dict(dtype="bfloat16", index_type="approx"),
    "e": dict(dtype="bfloat16", index_type="clustered", cluster_rows=256, nprobe=4),
}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each index built and saved by both packages from the same rows."""
    x, q = _data(3)
    ids = [f"doc-{i}" for i in range(N)]
    out = {}
    for name, kw in CASES.items():
        root = tmp_path_factory.mktemp(f"idx_{name}")
        tb = IndexBuilder(D, device="cpu", **kw).build_from_arrays(x, ids)
        jb = JBuilder(D, **kw).build_from_arrays(x, ids)
        tb.save(root / "torch")
        jb.save(root / "jax")
        out[name] = (root, tb, jb)
    return x, q, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_indexes_load_and_search_across_packages(saved, name):
    """The files are byte for byte the same from either package (bf16 rows
    and refine rows as descr '<V2'), each package loads the other's, the
    checksums agree, and both search alike: the refined engine for (a), on
    the device and on the host, each index's own engine otherwise."""
    x, q, out = saved
    root, tb, jb = out[name]
    files = sorted(p.name for p in (root / "jax").iterdir())
    assert files == sorted(p.name for p in (root / "torch").iterdir())
    for f in files:
        assert (root / "torch" / f).read_bytes() == (root / "jax" / f).read_bytes(), f
    meta = json.loads((root / "torch" / "meta.json").read_text())
    if CASES[name].get("refine_m"):
        assert np.load(root / "torch" / "refine.npy").dtype.kind == "V"
        header = (root / "torch" / "refine.npy").read_bytes()[:128].decode("latin1")
        assert "'descr': '<V2'" in header and "refine" in meta["checksums"]
    if CASES[name]["dtype"] == "bfloat16":
        assert "'descr': '<V2'" in (root / "torch" / "vectors.npy").read_bytes()[:128].decode(
            "latin1")
    t_from_j = IndexBuilder(device="cpu").load(root / "jax")
    j_from_t = JBuilder().load(root / "torch")
    np.testing.assert_array_equal(t_from_j._vectors.view(np.uint8),
                                  np.asarray(j_from_t._vectors).view(np.uint8))
    assert t_from_j.refine_m == j_from_t.refine_m == CASES[name].get("refine_m", 0)
    for storage in ("device", "host") if name == "a" else ("device",):
        t_from_j.refine_storage = j_from_t.refine_storage = storage
        tv, ti = t_from_j.search(q, k=10)
        jv, ji = j_from_t.search(q, k=10)
        _assert_same_topk(np.where(np.isfinite(tv), tv, tk.NEG_INF), ti,
                          np.where(np.isfinite(np.asarray(jv)), jv, tk.NEG_INF), ji)


@pytest.mark.parametrize("name", sorted(CASES))
def test_validate_equals_jax(saved, name):
    """validate() at the same seed: the same probes, the same ground truth
    (the refine rows where there are any), the same recall."""
    x, q, out = saved
    root, tb, jb = out[name]
    assert tb.validate(n_queries=60, seed=3) == jb.validate(n_queries=60, seed=3)


def test_corrupt_or_missing_refine_rows_are_rejected(saved, tmp_path):
    import shutil

    x, q, out = saved
    src = out["a"][0] / "torch"
    corrupt = tmp_path / "corrupt"
    shutil.copytree(src, corrupt)
    raw = bytearray((corrupt / "refine.npy").read_bytes())
    raw[-1] ^= 0x01
    (corrupt / "refine.npy").write_bytes(bytes(raw))
    missing = tmp_path / "missing"
    shutil.copytree(src, missing)
    (missing / "refine.npy").unlink()
    for path, what in ((corrupt, "checksum"), (missing, "missing")):
        with pytest.raises(IndexLoadError, match=what):
            IndexBuilder(device="cpu").load(path)
        with pytest.raises(JIndexLoadError, match=what):
            JBuilder().load(path)


def test_refine_storage_moves_the_rows(saved):
    """Setting refine_storage after placement drops the device copy (host) or
    restores it (device), as the JAX builder's setter does; an invalid value
    raises."""
    x, q, out = saved
    b = IndexBuilder(device="cpu").load(out["a"][0] / "torch")
    assert b.device_refine is None
    b.ensure_device()
    assert b.device_refine is not None and b.device_refine.dtype == torch.bfloat16
    b.refine_storage = "host"
    assert b.device_refine is None
    want = b.search(q, k=10)
    b.refine_storage = "device"
    assert torch.equal(b.device_refine.view(torch.int16),
                       torch.from_numpy(b._refine.view(np.int16)))
    got = b.search(q, k=10)
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(IndexBuildError, match="refine_storage"):
        b.refine_storage = "disk"
    with pytest.raises(IndexBuildError, match="refine_storage"):
        IndexBuilder(refine_storage="disk", device="cpu")
    with pytest.raises(IndexBuildError, match="int4"):
        IndexBuilder(dtype="int4", index_type="clustered", device="cpu")


def test_exact_index_with_refine_rows_is_searched_unrefined_by_the_library(saved):
    """IndexBuilder.search refines an approx index only (the JAX builder's
    rule): an exact int4 index with refine rows is its exact int4 sweep."""
    x, q, out = saved
    b = IndexBuilder(device="cpu").load(out["b"][0] / "torch")
    b.ensure_device()
    vals, idx = b.search(q, k=10)
    qn = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))
    want_v, want_i = tt.cosine_topk(qn, b.device_vectors, 10, row_scales=b.device_scales)
    np.testing.assert_array_equal(idx, want_i.numpy())
    refined = tt.refined_topk(qn, b.device_vectors, b.device_refine, 10, refine_m=40,
                              row_scales=b.device_scales)
    assert not np.array_equal(idx, refined[1].numpy())  # int4 alone orders differently


# ---------------------------------------------------------------------------
# Serving: the engine per index, refine_storage applied at startup
# ---------------------------------------------------------------------------

DOCS = [f"document about topic {i} with words {i * 7 % 13}" for i in range(40)]
QUERIES = ["find topic 3", "words 5 topic", "what about topic 17", "document"]


@pytest.fixture(scope="module")
def students():
    tok = JTokenizer.build_from_corpus(DOCS + ["query passage what find about"], vocab_size=512)
    js = JStudent("tiny-refine", config=JConfig.tiny(vocab_size=tok.vocab_size), tokenizer=tok)
    ts = StudentModel(
        "tiny-refine", device="cpu", config=BertConfig.tiny(vocab_size=tok.vocab_size),
        tokenizer=WordPieceTokenizer(tok.vocab),
        params=jax.tree_util.tree_map(np.asarray, js.params),
    )
    return js, ts, js.encode_documents(DOCS)


@pytest.mark.parametrize("kw,storage,want", [
    (CASES["a"], "device", "refined"), (CASES["a"], "host", "host_refined"),
    (CASES["b"], "device", "refined"), (CASES["b"], "host", "host_refined"),
    (CASES["c"], "device", "exact"), (CASES["d"], "host", "approx"),
    (dict(CASES["e"], cluster_rows=16), "device", "approx"),
    (dict(dtype="int8", index_type="clustered", cluster_rows=16, refine_m=8), "device",
     "approx"),
])
def test_fused_engine_follows_jax(students, kw, storage, want):
    """FusedSearcher._engine: refined (device) or host_refined for any
    non-clustered index with refine rows, the index's own type otherwise,
    approx for a clustered one; the same choice as the JAX package's."""
    js, ts, emb = students
    ids = [f"d{i}" for i in range(len(DOCS))]
    tb = IndexBuilder(emb.shape[1], refine_storage=storage, device="cpu",
                      **kw).build_from_arrays(emb, ids, texts=DOCS)
    jb = JBuilder(emb.shape[1], refine_storage=storage, **kw).build_from_arrays(emb, ids,
                                                                              texts=DOCS)
    assert FusedSearcher(ts, tb)._engine(16) == JFused(js, jb)._engine(16) == want


@pytest.mark.parametrize("storage", ["device", "host"])
@pytest.mark.parametrize("case", ["a", "b"])
def test_app_serves_refined_indexes_as_jax_does(monkeypatch, tmp_path, students, case,
                                                storage):
    """create_app loads a refine index, applies index.refine_storage to it,
    and serves the refined engine's ids, those of the JAX fused searcher."""
    js, ts, emb = students
    ids = [f"d{i}" for i in range(len(DOCS))]
    kw = dict(CASES[case], refine_m=12)
    jb = JBuilder(emb.shape[1], **kw).build_from_arrays(emb, ids, texts=DOCS)
    jb.save(tmp_path / "idx")
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **k: ts)
    settings = Settings.from_dict({"index": {"refine_storage": storage}})
    tc = TestClient(app_module.create_app(settings, device="cpu",
                                          preload_index_dir=str(tmp_path / "idx")))
    try:
        b = tc.app.state.index_builder
        assert b.refine_storage == storage and (b.device_refine is None) == (storage == "host")
        engine = "host_refined" if storage == "host" else "refined"
        assert tc.app.state.fused_searcher._engine(16) == engine
        jb.refine_storage = storage
        _, want = JFused(js, jb).search_texts(QUERIES, k=3)
        for q, want_ids in zip(QUERIES, want):
            got = tc.post("/search", json_body={"query": q, "k": 3}).json()["results"]
            assert [r["doc_id"] for r in got] == [f"d{i}" for i in want_ids]
    finally:
        tc.close()
