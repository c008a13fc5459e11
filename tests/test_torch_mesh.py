"""The port's mesh and the engines' ``index_offset`` against the JAX package:
``mesh_shape_for`` over a grid (results and refusals), ``create_mesh`` on
CPU entries and its refusals where CUDA is missing or short, and
``cosine_topk_core`` / ``cosine_topk`` / ``approx_topk`` / ``clustered_topk``
at a nonzero offset with a ``valid_n`` that cuts the last block. Tolerances:
int8 and int4 scores bit-exact with JAX, ids equal; f32 and bf16 ids equal
and scores within 1e-6 (only the summation order differs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sskd_tpu.ops.quant import quantize_rows as jquant8
from sskd_tpu.ops.quant import quantize_rows_int4 as jquant4
from sskd_tpu.ops.topk import cosine_topk_core as jcosine_topk_core
from sskd_tpu.ops.topk_cluster import clustered_topk as jclustered_topk
from sskd_tpu.parallel.mesh import create_mesh as jcreate_mesh
from sskd_tpu.parallel.mesh import mesh_shape_for as jmesh_shape_for
from sskd_tpu_torch.ops import _build
from sskd_tpu_torch.ops import topk as tt
from sskd_tpu_torch.ops import topk_kernels as tk
from sskd_tpu_torch.ops.cluster import auto_cells, build_clusters
from sskd_tpu_torch.ops.topk_cluster import clustered_topk
from sskd_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def _shape_or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dp", [-1, 1, 2, 4, 8])
@pytest.mark.parametrize("ip", [0, 1, 2, 3, 4, 8])
def test_mesh_shape_for_equals_jax(n, dp, ip):
    assert _shape_or_error(tmesh.mesh_shape_for, n, dp, ip) == \
        _shape_or_error(jmesh_shape_for, n, dp, ip)


@pytest.mark.parametrize("dp,ip", [(-1, 1), (-1, 2), (2, 4), (1, 8), (4, 2), (1, 2)])
def test_create_mesh_on_cpu_entries_has_the_jax_shape(dp, ip):
    mesh = tmesh.create_mesh(dp, ip, devices=[CPU] * 8)
    jmesh = jcreate_mesh(dp, ip)
    assert mesh.shape == dict(jmesh.shape) and mesh.axis_names == jmesh.axis_names
    assert len(mesh.devices_along("index")) == jmesh.shape["index"]
    assert len(mesh.devices_along("data")) == jmesh.shape["data"]
    with pytest.raises(ValueError, match="no axis"):
        mesh.devices_along("model")


def test_a_mesh_needs_cuda_unless_cpu_entries_are_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.create_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.local_devices("cuda")
    # more CUDA devices than the machine has: refused, no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.create_mesh(1, 1).devices == ((torch.device("cuda", 0),),)
    with pytest.raises(ValueError, match="must divide device count 1"):
        tmesh.create_mesh(1, 2)
    with pytest.raises(ValueError, match="needs more than"):
        tmesh.create_mesh(2, 1)


def test_cpu_entries_are_what_set_cpu_devices_said(monkeypatch):
    monkeypatch.setattr(tmesh, "_cpu_devices", 1)
    assert tmesh.local_devices("cpu") == [CPU]
    tmesh.set_cpu_devices(4)
    assert tmesh.local_devices("cpu") == [CPU] * 4
    assert tmesh.create_mesh(1, 4, devices=tmesh.local_devices("cpu")).shape == \
        {"data": 1, "index": 4}
    with pytest.raises(ValueError):
        tmesh.set_cpu_devices(0)


def test_a_kernel_launch_off_the_current_device_raises(monkeypatch):
    """A wrapper's stream is taken only on the current device (its C entry
    launches there): operands on another device raise before any launch."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1234 + index,
                        raising=False)
    assert tk._stream(torch.device("cuda", 0)) == 1234
    with pytest.raises(RuntimeError, match=r"torch.cuda.device\(cuda:1\)"):
        tk._stream(torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        _build.check_current_device(torch.device("cuda", 3))


# ---------------------------------------------------------------------------
# index_offset
# ---------------------------------------------------------------------------


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(dtype, x):
    """(torch corpus, torch scales, JAX corpus, JAX scales) of the JAX
    package's storage."""
    if dtype == "f32":
        return torch.from_numpy(x), None, jnp.asarray(x), None
    if dtype == "bf16":
        tx = torch.from_numpy(x).to(torch.bfloat16)
        return tx, None, jnp.asarray(x).astype(jnp.bfloat16), None
    v, s = (jquant8 if dtype == "int8" else jquant4)(jnp.asarray(x))
    return torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(s)), v, s


def _assert_same(t, j, tol, rtol=0.0):
    (tv, ti), (jv, ji) = t, j
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    live = ji >= 0
    np.testing.assert_allclose(tv[live], jv[live], rtol=rtol, atol=tol)
    assert (tv[~live] == tk.NEG_INF).all()


TOL = {"f32": 1e-6, "bf16": 1e-6, "int8": 0.0, "int4": 0.0}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("offset,valid_n,k", [
    (1000, 1000 + 650, 10),  # the last 128-row block cut at 650 of 700
    (1000, 1000 + 700, 10),  # no row cut
    (1000, 1000 + 100, 40),  # fewer live rows than the first block
    (640, 600, 5),  # the shard lies past the valid rows: every slot missing
    (0, 333, 5),
])
def test_cosine_topk_core_offset_matches_jax(dtype, method, offset, valid_n, k):
    """JAX on the CPU answers approx exactly (approx_max_k); so does the
    port below its bin count (recall_target 0.99 at k <= 40 and 700 rows)."""
    rng = np.random.default_rng(offset + valid_n + k)
    x = _normed(rng, 700, 64)
    q = _normed(rng, 4, 64)
    tc, ts, jc, js = _corpus(dtype, x)
    want = jcosine_topk_core(jnp.asarray(q), jc, k, block_rows=128, row_scales=js,
                             valid_n=valid_n, index_offset=offset, method=method)
    got = tt.cosine_topk_core(torch.from_numpy(q), tc, k, block_rows=128, row_scales=ts,
                              valid_n=valid_n, index_offset=offset, method=method)
    _assert_same(got, want, TOL[dtype])
    # the dispatching engine gives the same on the CPU
    _assert_same(tt.cosine_topk(torch.from_numpy(q), tc, k, block_rows=128, row_scales=ts,
                                valid_n=valid_n, index_offset=offset, method=method),
                 want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
@pytest.mark.parametrize("kernels", [False, True])
def test_approx_pass_with_an_offset_is_the_local_pass_shifted(dtype, kernels):
    """Where the strided pass runs (recall_target 0.5: 5 bins, 8 tiles), its
    result with an offset is its result over the shard's own valid rows with
    the offset added; the -1 of a missing result stays."""
    rng = np.random.default_rng(3)
    x = _normed(rng, 1000, 64)
    q = _normed(rng, 3, 64)
    tc, ts, _, _ = _corpus(dtype, x)
    qt = torch.from_numpy(q)
    for offset, valid_n in ((5000, 5000 + 900), (5000, 4000), (0, 1000)):
        got = tt.approx_topk(qt, tc, 8, row_scales=ts, valid_n=valid_n, recall_target=0.5,
                             kernels=kernels, index_offset=offset)
        local = max(0, min(1000, valid_n - offset))
        lv, li = tt.approx_topk(qt, tc, 8, row_scales=ts, valid_n=local, recall_target=0.5,
                                kernels=kernels)
        np.testing.assert_array_equal(got[0].numpy(), lv.numpy())
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.where(li.numpy() >= 0, li.numpy() + offset, -1))
        assert (got[1].numpy() < valid_n).all()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("B,nprobe", [(1, 3), (4, 3), (2, 99)])
def test_clustered_topk_offset_matches_jax(dtype, B, nprobe):
    """The cell probe of a shard: positions shifted by the offset before the
    valid_n mask, so the shard's padding cells resolve to (-inf, -1). Ids
    equal; scores within 1e-6 relative (the cell kernel multiplies the two
    scales in its own order, as tests/test_torch_clustered.py holds it)."""
    rng = np.random.default_rng(B + nprobe)
    x = _normed(rng, 1500, 64)
    n_cells, rpc = auto_cells(1500, 256)
    perm, cent = build_clusters(x, n_cells, rpc)
    xr = np.pad(x[perm], ((0, n_cells * rpc - 1500), (0, 0)))
    tc, ts, jc, js = _corpus(dtype, xr)
    if ts is not None:
        pad = slice(1500, None)
        ts[pad], js = 1.0, js.at[pad].set(1.0)
    q = _normed(rng, B, 64)
    offset, valid_n = 3 * rpc, 3 * rpc + 1400  # cuts the shard's last cell
    want = jclustered_topk(jnp.asarray(q), jc, jnp.asarray(cent), k=10, nprobe=nprobe,
                           rows_per_cell=rpc, row_scales=js, valid_n=valid_n,
                           index_offset=offset)
    got = clustered_topk(torch.from_numpy(q), tc, torch.from_numpy(cent), 10, nprobe, rpc,
                         row_scales=ts, valid_n=valid_n, index_offset=offset)
    _assert_same(got, want, 1e-7, rtol=1e-6)
    assert ((got[1] == -1) | ((got[1] >= offset) & (got[1] < valid_n))).all()
