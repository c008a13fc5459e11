"""The port's ShardedIndex on a CPU mesh against the JAX package's on its 8
virtual CPU devices, and against the port's single-device engines, at 1, 2
and 8 shards with a row count that pads the last shard: exact f32 / bf16 /
int8 / int4, approx int8, clustered int8 at batches under and over
CLUSTER_MAX_BATCH, and refine over int8 and int4 (refine_m 40). Then the
sskd-sharded-1 layout across packages and shard counts, a corrupt file,
and map_positions.

Tolerances: int8 and int4 sweeps give JAX's ids exactly and its scores
bit for bit; f32, bf16 and the bf16 rescore give its scores within 1e-6
and its ids but where a score lies within 1e-6 of the row's last one (a
tie that the summation order decides); the clustered cell scores within
1e-6 relative (the cell kernel multiplies the two scales in its own order)."""

import numpy as np
import pytest
import torch

from sskd_tpu.exceptions import IndexLoadError as JIndexLoadError
from sskd_tpu.index.builder import IndexBuilder as JBuilder
from sskd_tpu.index.sharded import ShardedIndex as JSharded
from sskd_tpu.parallel.mesh import create_mesh as jcreate_mesh
from sskd_tpu_torch.exceptions import IndexBuildError, IndexLoadError
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.index.sharded import ShardedIndex
from sskd_tpu_torch.ops.topk_cluster import CLUSTER_MAX_BATCH
from sskd_tpu_torch.parallel.mesh import create_mesh

N, D, K = 1000, 64, 10
TOL = 1e-6
SHARDS = [1, 2, 8]


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = _normed(rng, N, D)
    q = x[rng.integers(0, N, 70)] + 0.05 * rng.standard_normal((70, D)).astype(np.float32)
    return x, q.astype(np.float32), [f"d{i}" for i in range(N)]


def _meshes(shards):
    """(the port's CPU mesh, the JAX mesh over its virtual devices)."""
    return (create_mesh(1, shards, devices=[torch.device("cpu")] * shards),
            jcreate_mesh(data_parallel=8 // shards, index_parallel=shards))


def _assert_same(got, want, exact: bool, rtol: float = 0.0):
    """Ids equal (exact) or equal but at ties within TOL; scores within TOL
    (or rtol), missing results where JAX has them."""
    (tv, ti), (jv, ji) = (tuple(np.asarray(a) for a in r) for r in (got, want))
    assert ti.dtype == np.int32 and tv.shape == jv.shape
    live = ji >= 0
    np.testing.assert_array_equal(ti >= 0, live)
    if exact:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv[live], jv[live], rtol=rtol, atol=0)
        return
    np.testing.assert_allclose(tv[live], jv[live], rtol=rtol, atol=TOL)
    for r in range(ti.shape[0]):
        for i in set(ti[r]) ^ set(ji[r]):
            v = tv[r][ti[r] == i] if i in ti[r] else jv[r][ji[r] == i]
            assert abs(float(v[0]) - float(jv[r][live[r]][-1])) <= TOL, (r, i)


# ---------------------------------------------------------------------------
# Search, engine by engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_exact_search_matches_jax_and_the_single_device_engine(data, dtype, shards):
    x, q, ids = data
    mesh, jmesh = _meshes(shards)
    sh = ShardedIndex(mesh, block_rows=128).build_from_arrays(x, ids, dtype=dtype)
    jsh = JSharded(jmesh, block_rows=128).build_from_arrays(x, ids, dtype=dtype)
    assert sh.n_shards == jsh.n_shards == shards
    assert sh.rows_per_shard == jsh.rows_per_shard and sh.rows_per_shard * shards > N
    cols = D // 2 if dtype == "int4" else D
    assert all(v.shape == (sh.rows_per_shard, cols) for v in sh._vectors)
    quantized = dtype in ("int8", "int4")
    got = sh.search(q[:5], k=K)
    _assert_same(got, jsh.search(q[:5], k=K), exact=quantized)
    single = IndexBuilder(D, dtype=dtype, device="cpu").build_from_arrays(x, ids)
    _assert_same(got, single.search(q[:5], k=K), exact=True)


@pytest.mark.parametrize("shards", SHARDS)
def test_approx_int8_matches_jax_and_the_single_device_engine(data, shards):
    """JAX's approx sweep is exact on the CPU; the port's is exact at a
    shard's few 128-row tiles, as it is on one device."""
    x, q, ids = data
    mesh, jmesh = _meshes(shards)
    tb = IndexBuilder(D, index_type="approx", dtype="int8", device="cpu").build_from_arrays(x, ids)
    jb = JBuilder(D, index_type="approx", dtype="int8").build_from_arrays(x, ids)
    sh, jsh = ShardedIndex.from_builder(tb, mesh), JSharded.from_builder(jb, jmesh)
    assert sh.method == jsh.method == "approx"
    got = sh.search(q[:5], k=K)
    _assert_same(got, jsh.search(q[:5], k=K), exact=True)
    _assert_same(got, tb.search(q[:5], k=K), exact=True)


@pytest.fixture(scope="module")
def clustered(data):
    """A 12-cell int8 index of 3,000 rows (256 a cell) in both packages."""
    rng = np.random.default_rng(22)
    centers = _normed(rng, 8, D)
    x = centers[rng.integers(0, 8, 3000)] + 0.2 * rng.standard_normal((3000, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    q = x[rng.integers(0, 3000, 70)] + 0.05 * rng.standard_normal((70, D)).astype(np.float32)
    ids = [f"c{i}" for i in range(3000)]
    kw = dict(index_type="clustered", dtype="int8", cluster_rows=256, nprobe=3)
    tb = IndexBuilder(D, device="cpu", **kw).build_from_arrays(x, ids)
    jb = JBuilder(D, **kw).build_from_arrays(x, ids)
    assert tb._centroids.shape[0] == 12 and tb._rows_per_cell == 256
    return tb, jb, q.astype(np.float32)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("B", [5, CLUSTER_MAX_BATCH + 6], ids=["probe", "sweep"])
def test_clustered_int8_matches_jax(clustered, shards, B):
    """Each shard probes nprobe of its own cells (8 shards: 2 cells each,
    the last shard's two zero-centroid padding cells masked), or above
    CLUSTER_MAX_BATCH sweeps its rows; at one shard that is the
    single-device engine."""
    tb, jb, q = clustered
    mesh, jmesh = _meshes(shards)
    sh, jsh = ShardedIndex.from_builder(tb, mesh), JSharded.from_builder(jb, jmesh)
    assert sh.rows_per_shard == jsh.rows_per_shard == -(-12 // shards) * 256
    got = sh.search(q[:B], k=K)
    _assert_same(got, jsh.search(q[:B], k=K), exact=True, rtol=1e-6)
    if shards == 1:
        _assert_same(got, tb.search(q[:B], k=K), exact=True)
    assert set(got[1].ravel()) <= set(range(3000))  # original rows, mapped back


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_refine_rescore_matches_jax_and_the_single_device_engine(data, dtype, shards):
    """Each shard rescores its own refine_m = 40 candidates against its bf16
    rows; at one shard that is the single-device refined engine."""
    x, q, ids = data
    mesh, jmesh = _meshes(shards)
    sh = ShardedIndex(mesh, block_rows=128).build_from_arrays(x, ids, dtype=dtype, refine_m=40)
    jsh = JSharded(jmesh, block_rows=128).build_from_arrays(x, ids, dtype=dtype, refine_m=40)
    assert sh.refine_m == 40 and all(r.dtype == torch.bfloat16 for r in sh._refine)
    got = sh.search(q[:5], k=K)
    _assert_same(got, jsh.search(q[:5], k=K), exact=False)
    if shards == 1:
        single = IndexBuilder(D, index_type="approx", dtype=dtype, refine_m=40,
                              device="cpu").build_from_arrays(x, ids)
        _assert_same(got, single.search(q[:5], k=K), exact=True)
    with pytest.raises(IndexBuildError):
        ShardedIndex(mesh).build_from_arrays(x, ids, dtype="float32", refine_m=8)


def test_a_shard_of_padding_rows_only_answers_missing_results():
    """300 rows over 8 shards of 128: shards 3-7 hold no valid row; k past
    the row count pads with (-inf, -1) as the single-device engine does."""
    rng = np.random.default_rng(23)
    x, q = _normed(rng, 300, 32), _normed(rng, 3, 32)
    ids = [str(i) for i in range(300)]
    mesh, jmesh = _meshes(8)
    sh = ShardedIndex(mesh, block_rows=128).build_from_arrays(x, ids, dtype="int8")
    jsh = JSharded(jmesh, block_rows=128).build_from_arrays(x, ids, dtype="int8")
    got = sh.search(q, k=400)
    _assert_same(got, jsh.search(q, k=400), exact=True)
    assert (got[1][:, 300:] == -1).all() and (got[1][:, :300] >= 0).all()


# ---------------------------------------------------------------------------
# The sskd-sharded-1 layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,refine_m", [("float32", 0), ("bfloat16", 0), ("int8", 0),
                                            ("int4", 40)])
def test_saves_load_across_packages_and_shard_counts(data, tmp_path, dtype, refine_m):
    """JAX saves at 2 shards, the port loads at 8 and 1; the port saves at 8,
    JAX loads at 2; every load ranks as the source did. The files the port
    writes are the JAX package's, checksums included."""
    x, q, ids = data
    mesh8, jmesh2 = _meshes(8)[0], _meshes(2)[1]
    jsrc = JSharded(jmesh2, block_rows=128).build_from_arrays(x, ids, dtype=dtype,
                                                              refine_m=refine_m)
    want = jsrc.search(q[:5], k=K)
    jsrc.save(tmp_path / "jax")
    for shards in (8, 1):
        got = ShardedIndex(_meshes(shards)[0], block_rows=128).load(tmp_path / "jax")
        assert (got.ntotal, got.dtype, got.refine_m, got.doc_ids) == (N, dtype, refine_m, ids)
        _assert_same(got.search(q[:5], k=K), want, exact=dtype in ("int8", "int4") and
                     not refine_m)
    src = ShardedIndex(mesh8, block_rows=128).build_from_arrays(x, ids, dtype=dtype,
                                                                refine_m=refine_m)
    src.save(tmp_path / "port")
    for name in ("vectors.npy", "scales.npy", "refine.npy", "doc_ids.json"):
        if (tmp_path / "jax" / name).exists():
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    loaded = JSharded(jmesh2, block_rows=128).load(tmp_path / "port")
    _assert_same(src.search(q[:5], k=K), loaded.search(q[:5], k=K),
                 exact=dtype in ("int8", "int4") and not refine_m)


def test_clustered_layout_across_packages_and_map_positions(clustered, tmp_path):
    tb, jb, q = clustered
    mesh8, jmesh2 = _meshes(8)[0], _meshes(2)[1]
    JSharded.from_builder(jb, jmesh2).save(tmp_path / "jax")
    got = ShardedIndex(mesh8).load(tmp_path / "jax")
    assert (got._n_cells, got._rows_per_cell, got.nprobe) == (12, 256, 3)
    np.testing.assert_array_equal(got._perm, tb._perm)
    _assert_same(got.search(q[:5], k=K), JSharded.from_builder(jb, _meshes(8)[1]).search(
        q[:5], k=K), exact=True, rtol=1e-6)
    ShardedIndex.from_builder(tb, mesh8).save(tmp_path / "port")
    for name in ("vectors.npy", "scales.npy", "perm.npy", "centroids.npy"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # map_positions: engine positions (cell-reordered) -> original rows
    pos = np.array([[0, 5, -1], [2999, 256, 1]], dtype=np.int32)
    np.testing.assert_array_equal(got.map_positions(pos), tb.map_positions(pos))
    np.testing.assert_array_equal(got.map_positions(pos),
                                  JSharded.from_builder(jb, jmesh2).map_positions(pos))
    assert got.map_positions(pos).dtype == np.int32


def test_corrupt_or_missing_files_are_refused(data, tmp_path):
    x, _, ids = data
    mesh, jmesh = _meshes(2)
    out = ShardedIndex(mesh, block_rows=128).build_from_arrays(
        x, ids, dtype="int8", refine_m=16).save(tmp_path / "idx")
    blob = (out / "vectors.npy").read_bytes()
    (out / "vectors.npy").write_bytes(blob[:-4] + b"\x00\x00\x00\x00")
    with pytest.raises(IndexLoadError, match="vectors"):
        ShardedIndex(mesh).load(out)
    with pytest.raises(JIndexLoadError):
        JSharded(jmesh).load(out)
    (out / "vectors.npy").write_bytes(blob)
    (out / "refine.npy").unlink()
    with pytest.raises(IndexLoadError, match="refine"):
        ShardedIndex(mesh).load(out)
