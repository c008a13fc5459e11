"""Port vs JAX: clustered (cell-probe) search, from the clustering to the app.

The same seeded numpy inputs go to both packages; the port runs on the CPU,
where its kernel wrappers run their plain torch versions. The JAX package's
two cell-gather Pallas kernels run in TPU interpret mode
(``pltpu.force_tpu_interpret_mode``); its ``clustered_topk`` takes its XLA
path on the CPU, as in its own tests.

Tolerances: int8 scores are an exact integer dot times two f32 scales, so a
plain version equals its own Pallas kernel bit for bit, while the XLA path
multiplies the two scales in the other order than the general kernel (last
bit, rtol 1e-6). f32 scores differ by summation order (1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu.models import BertConfig as JConfig, StudentModel as JStudent
from sskd_tpu.ops import cluster as jc
from sskd_tpu.ops import topk_cluster as jt
from sskd_tpu.ops.quant import quantize_rows as jquant8
from sskd_tpu.ops.topk import cosine_topk as jcosine_topk
from sskd_tpu.serve.fused import FusedSearcher as JFused
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.exceptions import IndexBuildError
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.ops import cluster as tc
from sskd_tpu_torch.ops import topk_cluster as tt
from sskd_tpu_torch.serve import app as app_module
from sskd_tpu_torch.serve.fused import FusedSearcher
from sskd_tpu_torch.serve.http import TestClient
from sskd_tpu_torch.tokenization import WordPieceTokenizer
from torch_tc_emulation import CELL_RUN, cell_gather_tc


def _mixture(n, d, n_modes, spread, seed=0):
    """Gaussian-mixture corpus on the sphere (the recipe of test_clustered.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_modes, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_modes, n)
    x = centers[assign] + spread * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x.astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# Clustering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,target", [(3000, 256), (2048, 256), (1100, 512), (300, 256)])
def test_build_clusters_bit_equal(n, target):
    """Whole cells, a short last cell, and fewer rows than two cells."""
    x = _mixture(n, 32, 8, 0.2, seed=n)
    assert tc.auto_cells(n, target) == jc.auto_cells(n, target)
    n_cells, rpc = tc.auto_cells(n, target)
    jperm, jcent = jc.build_clusters(x, n_cells, rpc)
    tperm, tcent = tc.build_clusters(x, n_cells, rpc)
    assert tperm.dtype == jperm.dtype and tcent.dtype == jcent.dtype
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tcent, jcent)


def test_auto_cells_matches_jax():
    for n in (1, 255, 65536, 1_000_000, 10_000_000):
        assert tc.auto_cells(n) == jc.auto_cells(n)
    assert tc.auto_cells(1_000_000) == (977, 1024)
    assert tc.CELL_ROW_MULTIPLE == jc.CELL_ROW_MULTIPLE


# ---------------------------------------------------------------------------
# The plain cell-gather versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cells():
    """A 12-cell corpus of 3,000 x 128 rows in both storages, padded to whole cells."""
    x = _mixture(3000, 128, 8, 0.2)
    n_cells, rpc = tc.auto_cells(3000, 256)
    perm, cent = tc.build_clusters(x, n_cells, rpc)
    xr = x[perm]
    pad = n_cells * rpc - 3000
    xq, s = jquant8(xr)
    return {
        "x": x, "perm": perm, "cent": cent, "rpc": rpc, "n_cells": n_cells, "n": 3000,
        "f32": (np.pad(xr, ((0, pad), (0, 0))), None),
        "int8": (np.pad(np.asarray(xq), ((0, pad), (0, 0))),
                 np.pad(np.asarray(s), (0, pad), constant_values=1.0)),
        "q": _mixture(5, 128, 8, 0.2, seed=5),
    }


HAS_INTERPRET = hasattr(pltpu, "force_tpu_interpret_mode")


def _pallas_cell_scores(q, q_in, q_scale, probe, corpus, scales, rpc):
    """The JAX package's own kernel for this batch size, in interpret mode;
    on a JAX without that mode, its XLA path (which multiplies the two int8
    scales in the one-query kernel's order)."""
    nprobe = probe.shape[1]
    qs = None if q_scale is None else _j(q_scale)[:, None]
    if not HAS_INTERPRET:
        out = jt._cell_scores_xla(
            _j(q_in), qs, _j(probe), _j(corpus), _j(scales), corpus.shape[0] // rpc, rpc,
            nprobe, corpus.dtype == np.int8,
        )
        return np.asarray(out).reshape(q.shape[0], nprobe, rpc)
    with pltpu.force_tpu_interpret_mode():
        if q.shape[0] == 1:
            out = jt._cell_scores_pallas_b1(
                _j(q_in), qs, _j(probe), _j(corpus), _j(scales), rpc, nprobe
            )
        else:
            out = jt._cell_scores_pallas(
                _j(q), _j(q_in), qs, _j(probe), _j(corpus), _j(scales), rpc, nprobe
            )
    return np.asarray(out)


@pytest.mark.parametrize("dtype", ["int8", "f32"])
@pytest.mark.parametrize("nprobe", [3, 8, 11])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_cell_gather_matches_pallas(cells, dtype, nprobe, B):
    corpus, scales = cells[dtype]
    q = cells["q"][:B]
    probe = np.argsort(-(q @ cells["cent"].T), axis=1, kind="stable")[:, :nprobe].astype(np.int32)
    q_in, q_scale = tt.quantize_queries(_t(q), _t(corpus))
    want = _pallas_cell_scores(
        q, q_in.numpy(), None if q_scale is None else q_scale.numpy(), probe, corpus, scales,
        cells["rpc"],
    )
    wrapper = tt.cell_gather_b1 if B == 1 else tt.cell_gather
    before = wrapper.launches
    got = wrapper(q_in, q_scale, _t(corpus), _t(scales), _t(probe), cells["rpc"]).numpy()
    assert wrapper.launches == before  # a CPU tensor launches nothing
    assert got.shape == (B, nprobe, cells["rpc"]) and got.dtype == np.float32
    print("compared with", "the Pallas kernel, interpreted" if HAS_INTERPRET else "the XLA path")
    if dtype == "int8" and (HAS_INTERPRET or B == 1):
        np.testing.assert_array_equal(got, want)
    else:  # f32: summation order; int8 against XLA at B > 1: the scales' order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,nprobe,rpc,d,same", [
    (2, 3, 256, 128, False), (16, 8, 256, 128, False), (64, 5, 200, 48, False),
    (200, 11, 768, 64, True), (3, 11, 768, 64, False),
])
def test_tensor_core_cell_gather_schedule_reads_each_cell_once(B, nprobe, rpc, d, same):
    """The int8 tensor-core cell gather's schedule (tests/torch_tc_emulation.py):
    every (query, slot) pair is scored, bit for bit as cell_gather_plain
    scores it, and every distinct probed cell is brought in once, also where
    a cell's pairs straddle two runs of the sorted order and where every
    query probes the same cells. d = 48 is not a whole number of the mma's
    32-byte steps; rpc = 200 ends on a partial tile."""
    n_cells = 20
    rng = np.random.default_rng(B * 1000 + nprobe)
    x = rng.standard_normal((n_cells * rpc, d)).astype(np.float32)
    xq, xs = (_t(np.asarray(a)) for a in jquant8(x))
    q_in, q_scale = tt.quantize_queries(_t(rng.standard_normal((B, d)).astype(np.float32)), xq)
    if same:
        probe = np.tile(rng.permutation(n_cells)[:nprobe], (B, 1))
    else:
        probe = np.stack([rng.permutation(n_cells)[:nprobe] for _ in range(B)])
    probe = _t(probe.astype(np.int32))
    got, loads = cell_gather_tc(q_in, q_scale, xq, xs, probe, rpc)
    want = tt.cell_gather(q_in, q_scale, xq, xs, probe, rpc)
    assert torch.equal(got, want)  # no NaN left: every pair scored
    assert sorted(loads) == sorted(set(probe.reshape(-1).tolist()))
    assert set(loads.values()) == {1}
    sorted_cells = torch.sort(probe.reshape(-1)).values
    bounds = range(CELL_RUN, B * nprobe, CELL_RUN)
    straddles = sum(int(sorted_cells[i - 1] == sorted_cells[i]) for i in bounds)
    assert straddles > 0 or B * nprobe <= CELL_RUN


def test_cell_gather_wrappers_refuse_bad_operands(cells):
    corpus, scales = (_t(a) for a in cells["int8"])
    q_in, q_scale = tt.quantize_queries(_t(cells["q"][:2]), corpus)
    probe = torch.zeros((2, 3), dtype=torch.int32)
    rpc = cells["rpc"]
    with pytest.raises(ValueError, match="one query"):
        tt.cell_gather_b1(q_in, q_scale, corpus, scales, probe, rpc)
    with pytest.raises(ValueError, match="row_scales"):
        tt.cell_gather(q_in, q_scale, corpus, None, probe, rpc)
    with pytest.raises(ValueError, match="q_scale"):
        tt.cell_gather(q_in, None, corpus, scales, probe, rpc)
    with pytest.raises(ValueError, match="int32"):
        tt.cell_gather(q_in, q_scale, corpus, scales, probe.long(), rpc)
    with pytest.raises(TypeError):
        tt.cell_gather(q_in.float(), q_scale, corpus, scales, probe, rpc)
    with pytest.raises(TypeError):
        tt.cell_gather(q_in.half(), q_scale, corpus.half(), scales, probe, rpc)


# ---------------------------------------------------------------------------
# clustered_topk
# ---------------------------------------------------------------------------


def _clustered_both(cells, dtype, q, k, nprobe):
    corpus, scales = cells[dtype]
    jv, ji = jt.clustered_topk(
        _j(q), _j(corpus), _j(cells["cent"]), k=k, nprobe=nprobe, rows_per_cell=cells["rpc"],
        row_scales=_j(scales), valid_n=cells["n"],
    )
    tv, ti = tt.clustered_topk(
        _t(q), _t(corpus), _t(cells["cent"]), k, nprobe, cells["rpc"], row_scales=_t(scales),
        valid_n=cells["n"],
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _assert_same(j, t):
    (jv, ji), (tv, ti) = j, t
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    live = ji >= 0
    np.testing.assert_allclose(tv[live], jv[live], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tv[~live], jv[~live])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("B,k,nprobe", [(1, 10, 4), (3, 10, 4), (5, 1, 1), (2, 40, 99)])
def test_clustered_topk_matches_jax(cells, dtype, B, k, nprobe):
    """nprobe 99 is clipped to the 12 cells; B = 1 takes the one-query pair."""
    _assert_same(*_clustered_both(cells, dtype, cells["q"][:B], k, nprobe))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_full_nprobe_equals_exact_engine(cells, dtype):
    from sskd_tpu_torch.ops.topk import cosine_topk_core

    corpus, scales = (_t(a) for a in cells[dtype])
    q = _t(cells["q"])
    tv, ti = tt.clustered_topk(
        q, corpus, _t(cells["cent"]), 10, cells["n_cells"], cells["rpc"], row_scales=scales,
        valid_n=cells["n"],
    )
    ev, ei = cosine_topk_core(q, corpus, 10, row_scales=scales, valid_n=cells["n"])
    np.testing.assert_array_equal(ti.numpy(), ei.numpy())
    np.testing.assert_allclose(tv.numpy(), ev.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_k_beyond_probed_rows_pads_and_tail_never_returned(cells, dtype):
    """k = 700 > 2 cells x 256 rows pads with (-inf, -1); with every cell
    probed and k past the corpus the 72 padding rows never come back."""
    j, t = _clustered_both(cells, dtype, cells["q"][:2], 700, 2)
    _assert_same(j, t)
    assert (t[1][:, 512:] == -1).all() and (t[1][:, :512] >= 0).all()
    j, t = _clustered_both(cells, dtype, cells["q"][:2], 3072, cells["n_cells"])
    _assert_same(j, t)
    assert (t[1] < cells["n"]).all() and (t[1][:, : cells["n"]] >= 0).all()
    assert (t[1][:, cells["n"]:] == -1).all()


def test_flat_topk_is_exact_and_breaks_ties_low():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8192)).astype(np.float32)
    x[0, 4000] = x[0, 77] = 9.0  # a tie across bins: the lower position first
    x[1, :] = tt.NEG_INF
    x[1, 5], x[1, 4000] = 3.0, 2.0  # fewer live bins than k
    vals, idx = tt.flat_topk(torch.from_numpy(x), 10)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 10)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idx.numpy()[[0, 2, 3]], np.asarray(ref_i)[[0, 2, 3]])
    assert idx[0, :2].tolist() == [77, 4000] and idx[1, :2].tolist() == [5, 4000]
    assert (vals[1, 2:] <= tt.NEG_INF / 2).all()
    narrow = torch.from_numpy(x[:, :300].copy())
    np.testing.assert_array_equal(
        tt.flat_topk(narrow, 5)[1].numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x[:, :300]), 5)[1])
    )


# ---------------------------------------------------------------------------
# IndexBuilder
# ---------------------------------------------------------------------------

N_ROWS, DIM = 1500, 32


def _builders(dtype, nprobe=4):
    x = _mixture(N_ROWS, DIM, 6, 0.15) * 2.5  # unnormalized: the builders normalize
    ids = [f"d{i}" for i in range(N_ROWS)]
    texts = [f"text {i}" for i in range(N_ROWS)]
    kw = dict(embedding_dim=DIM, index_type="clustered", dtype=dtype, cluster_rows=256,
              nprobe=nprobe)
    jb = JBuilder(**kw).build_from_arrays(x, ids, texts=texts)
    tb = IndexBuilder(**kw, device="cpu").build_from_arrays(x, ids, texts=texts)
    return x, jb, tb


def _search_both(jb, tb, q, k):
    jv, ji = jb.search(q, k=k)
    tv, ti = tb.search(q, k=k)
    np.testing.assert_array_equal(ti, ji)
    live = ji >= 0
    np.testing.assert_allclose(tv[live], jv[live], rtol=1e-6, atol=1e-7)
    return ti


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_builder_writes_the_same_files_and_each_loads_the_other(tmp_path, dtype):
    x, jb, tb = _builders(dtype)
    jb.save(tmp_path / "jax")
    tb.save(tmp_path / "torch")
    for name in ("vectors.npy", "perm.npy", "centroids.npy", "norms.npy", "doc_ids.json",
                 "texts.json", "meta.json", "INDEX_VERSION") + (
                     ("scales.npy",) if dtype == "int8" else ()):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes(), name
    j_from_t = JBuilder().load(tmp_path / "torch")
    t_from_j = IndexBuilder(device="cpu").load(tmp_path / "jax")
    assert t_from_j.index_type == j_from_t.index_type == "clustered"
    assert t_from_j.nprobe == j_from_t.nprobe == 4
    assert t_from_j._rows_per_cell == j_from_t._rows_per_cell == 256
    q = _mixture(7, DIM, 6, 0.15, seed=9)
    ids = _search_both(j_from_t, t_from_j, q, k=10)
    np.testing.assert_array_equal(ids, tb.search(q, k=10)[1])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_builder_search_small_and_large_batches(dtype):
    """B <= 64 probes cells; B > 64 falls through to the approx sweep over
    the reordered rows. Both return original positions, as the JAX builder."""
    x, jb, tb = _builders(dtype)
    ids = _search_both(jb, tb, x[:8], k=3)
    np.testing.assert_array_equal(ids[:, 0], np.arange(8))  # self-retrieval
    _search_both(jb, tb, x[100:101], k=10)  # one query: the one-query pair
    _search_both(jb, tb, x[: tt.CLUSTER_MAX_BATCH], k=5)
    ids = _search_both(jb, tb, x[: tt.CLUSTER_MAX_BATCH + 8], k=3)
    np.testing.assert_array_equal(ids[:, 0], np.arange(tt.CLUSTER_MAX_BATCH + 8))


def test_builder_dispatch_and_validate_chunks(monkeypatch):
    """search() probes cells up to CLUSTER_MAX_BATCH queries and sweeps above;
    validate() feeds the clustered engine at most CLUSTER_MAX_BATCH at a time."""
    from sskd_tpu_torch.index import builder as builder_module

    x, jb, tb = _builders("int8")
    calls = []
    real_clustered, real_sweep = builder_module.clustered_topk, builder_module.cosine_topk

    def clustered(q, *a, **kw):
        calls.append(("clustered", q.shape[0]))
        return real_clustered(q, *a, **kw)

    def sweep(q, *a, **kw):
        calls.append((kw["method"], q.shape[0]))
        return real_sweep(q, *a, **kw)

    monkeypatch.setattr(builder_module, "clustered_topk", clustered)
    monkeypatch.setattr(builder_module, "cosine_topk", sweep)
    tb.search(x[:64], k=3)
    tb.search(x[:65], k=3)
    assert calls == [("clustered", 64), ("approx", 65)]
    calls.clear()
    report = tb.validate(n_queries=150, k=10)
    assert calls == [("clustered", 64), ("clustered", 64), ("clustered", 22)]
    want = jb.validate(n_queries=150, k=10)
    assert report["n_queries"] == 150.0
    assert report["recall@10"] >= 0.9 and abs(report["recall@10"] - want["recall@10"]) <= 0.01


def test_builder_constructor_follows_jax():
    """cluster_rows and nprobe sit where the JAX builder has them, with its defaults."""
    tb = IndexBuilder(32, "clustered", "cosine", "int8", 1024, 0.9, 512, 7, device="cpu")
    jb = JBuilder(32, "clustered", "cosine", "int8", 1024, 0.9, 512, 7)
    for name in ("embedding_dim", "index_type", "metric", "dtype", "block_rows",
                 "recall_target", "cluster_rows", "nprobe"):
        assert getattr(tb, name) == getattr(jb, name), name
    assert IndexBuilder(device="cpu").nprobe == JBuilder().nprobe == 64
    assert IndexBuilder(device="cpu").cluster_rows == JBuilder().cluster_rows == 0
    with pytest.raises(IndexBuildError, match="int4"):
        IndexBuilder(32, index_type="clustered", dtype="int4", device="cpu")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

DOCS = [f"document about topic {i} with words {i}" for i in range(600)]
QUERIES = ["find topic 3", "find topic 17"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny student on both sides and a clustered int8 index of its document
    embeddings (nprobe 3 == n_cells for 600 rows: the probe path is exhaustive)."""
    tok = JTokenizer.build_from_corpus(DOCS[:50] + ["query find topic"], vocab_size=512)
    js = JStudent("tiny-clustered", config=JConfig.tiny(vocab_size=tok.vocab_size), tokenizer=tok)
    ts = StudentModel(
        "tiny-clustered", device="cpu", config=BertConfig.tiny(vocab_size=tok.vocab_size),
        tokenizer=WordPieceTokenizer(tok.vocab),
        params=jax.tree_util.tree_map(np.asarray, js.params),
    )
    emb = js.encode_documents(DOCS)
    ids = [f"d{i}" for i in range(len(DOCS))]
    kw = dict(embedding_dim=js.embedding_dim, index_type="clustered", dtype="int8",
              cluster_rows=256, nprobe=3)
    jb = JBuilder(**kw).build_from_arrays(emb, ids, texts=DOCS)
    idx_dir = tmp_path_factory.mktemp("clustered_idx")
    jb.save(idx_dir)
    tb = IndexBuilder(device="cpu").load(idx_dir)
    return js, ts, jb, tb, str(idx_dir)


def test_engine_selection_by_batch(served, monkeypatch):
    js, ts, jb, tb, _ = served
    fused, jfused = FusedSearcher(ts, tb), JFused(js, jb)
    monkeypatch.delenv("SSKD_SERVE_CELL_PROBE", raising=False)
    for n in (16, tt.CLUSTER_MAX_BATCH, tt.CLUSTER_MAX_BATCH * 2):
        assert fused._engine(n) == jfused._engine(n) == "approx"
    monkeypatch.setenv("SSKD_SERVE_CELL_PROBE", "1")
    for n, want in ((16, "clustered"), (tt.CLUSTER_MAX_BATCH, "clustered"),
                    (tt.CLUSTER_MAX_BATCH * 2, "approx")):
        assert fused._engine(n) == jfused._engine(n) == want
    assert tt.CLUSTER_MAX_BATCH == jt.CLUSTER_MAX_BATCH


@pytest.mark.parametrize("cell_probe", ["1", "0"])
def test_fused_clustered_matches_builder_and_jax(served, monkeypatch, cell_probe):
    """Cell probe opted in (clustered engine) and the default (approx sweep
    over the reordered rows): the fused hits equal builder.search on the same
    embeddings and the JAX fused searcher's, in original positions."""
    js, ts, jb, tb, _ = served
    monkeypatch.setenv("SSKD_SERVE_CELL_PROBE", cell_probe)
    fused = FusedSearcher(ts, tb)
    fv, fi = fused.search_texts(QUERIES, k=5)
    uv, ui = tb.search(ts.encode_queries(QUERIES), k=5)
    np.testing.assert_array_equal(fi, ui)
    np.testing.assert_allclose(fv, uv, atol=1e-4)
    jfused = JFused(js, jb)
    jv, ji = jfused.search_texts(QUERIES, k=5)
    np.testing.assert_array_equal(fi, ji)
    np.testing.assert_allclose(fv, jv, atol=1e-4)
    many = [f"find topic {i}" for i in range(tt.CLUSTER_MAX_BATCH + 1)]
    fv, fi = fused.search_texts(many, k=5)
    assert fi.shape == (len(many), 5) and (fi < 600).all() and (fi >= 0).all()


def _client(monkeypatch, ts, idx_dir, settings=None):
    monkeypatch.setattr(app_module, "StudentModel", lambda *a, **k: ts)
    return TestClient(app_module.create_app(settings or Settings(), device="cpu",
                                            preload_index_dir=idx_dir))


@pytest.mark.parametrize("cell_probe", ["1", "0"])
def test_app_serves_a_clustered_index_under_default_settings(served, monkeypatch, cell_probe):
    """The index keeps the type it records (the default search_method is
    approx) and /search answers with the JAX fused searcher's documents."""
    js, ts, jb, tb, idx_dir = served
    monkeypatch.setenv("SSKD_SERVE_CELL_PROBE", cell_probe)
    tc_ = _client(monkeypatch, ts, idx_dir)
    try:
        b = tc_.app.state.index_builder
        assert b.index_type == "clustered" and b.nprobe == 3
        _, want = JFused(js, jb).search_texts(QUERIES, k=5)
        for q, want_ids in zip(QUERIES, want):
            r = tc_.post("/search", json_body={"query": q, "k": 5})
            assert r.status == 200, r.body
            assert [x["doc_id"] for x in r.json()["results"]] == [f"d{i}" for i in want_ids]
            assert r.json()["results"][0]["text"] == DOCS[want_ids[0]]
    finally:
        tc_.close()


def test_explicit_nprobe_overrides_the_saved_one(served, monkeypatch):
    """An index.nprobe that the settings were given wins over meta.json at
    load; the default (64) does not. from_env records its names too."""
    js, ts, jb, tb, idx_dir = served
    assert not Settings().is_set("index", "nprobe")
    explicit = Settings.from_dict({"index": {"nprobe": 2}})
    assert explicit.is_set("index", "nprobe") and not explicit.is_set("index", "cluster_rows")
    from_env = Settings.from_env(environ={"SEMANTIC_KD_INDEX__NPROBE": "1"})
    assert from_env.is_set("index", "nprobe") and from_env.index.nprobe == 1
    layered = Settings.from_dict({"search": {"default_k": 5}}, base=explicit)
    assert layered.is_set("index", "nprobe") and layered.index.nprobe == 2
    for settings, want in ((Settings(), 3), (explicit, 2), (from_env, 1)):
        tc_ = _client(monkeypatch, ts, idx_dir, settings)
        try:
            assert tc_.app.state.index_builder.nprobe == want
            assert tc_.post("/search", json_body={"query": QUERIES[0], "k": 3}).status == 200
        finally:
            tc_.close()
    assert IndexBuilder(device="cpu").load(idx_dir).nprobe == 3  # meta.json is untouched


def test_index_config_follows_jax():
    from sskd_tpu.config import IndexConfig as JIndexConfig
    from sskd_tpu_torch.config import IndexConfig
    from sskd_tpu_torch.exceptions import ConfigError

    jdefault, tdefault = JIndexConfig(), IndexConfig()
    for name in ("search_method", "recall_target", "block_rows", "cluster_rows", "nprobe",
                 "refine_m", "refine_storage", "validation_queries",
                 "validation_recall_at_10"):
        assert getattr(tdefault, name) == getattr(jdefault, name), name
    for bad in ({"recall_target": 0.4}, {"recall_target": 1.1}, {"block_rows": 64},
                {"cluster_rows": -1}, {"nprobe": 0}, {"validation_queries": 0},
                {"validation_recall_at_10": 1.5}, {"refine_m": -1},
                {"refine_storage": "disk"}):
        with pytest.raises(ConfigError):
            Settings.from_dict({"index": bad})
        with pytest.raises(Exception):
            JIndexConfig(**bad)


def test_approx_fallthrough_matches_jax_sweep(cells):
    """Above CLUSTER_MAX_BATCH both builders sweep the reordered rows with
    the approx engine: at 12 cells x 256 rows (24 bins) that sweep is exact
    on both sides."""
    corpus, scales = cells["int8"]
    q = _mixture(70, 128, 8, 0.2, seed=11)
    jv, ji = jcosine_topk(_j(q), _j(corpus), k=10, row_scales=_j(scales), valid_n=cells["n"],
                          method="approx")
    from sskd_tpu_torch.ops.topk import cosine_topk

    tv, ti = cosine_topk(_t(q), _t(corpus), 10, row_scales=_t(scales), valid_n=cells["n"],
                         method="approx")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
