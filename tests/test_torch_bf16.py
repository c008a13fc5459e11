"""Port vs JAX: bf16 rows, from their storage to the kernels' plain versions.

The same seeded numpy inputs go to both packages; the port runs on the CPU,
where its kernel wrappers run their plain torch versions. Two rules, each
held to its own TPU kernel:

- ``binmax``, ``bin_gather`` and the approx pass (the TPU kernels' bf16
  branch, ``topk_pallas.py`` and ``topk.py _approx_topk``): bf16 rows widened
  exactly against the f32 query, f32 sums;
- the cell kernels: the query rounded to bf16 first (``topk_cluster.py``
  ``q.astype(corpus.dtype)``, the one-query kernel and the XLA path), each
  product of two bf16 exact in f32, f32 sums. The JAX package's general
  cell kernel is handed the f32 query instead (``_cell_scores_pallas``); the
  port follows the rounding of the other two paths, which is what the JAX
  ``clustered_topk`` computes on the CPU.

Scores differ only by summation order: within 2e-6 at D = 64; ids equal.
"""

from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sskd_tpu.ops import topk_cluster as jt
from sskd_tpu.ops.topk import cosine_topk as jcosine_topk
from sskd_tpu.ops.topk_pallas import cosine_topk_pallas_impl
from sskd_tpu_torch.index import builder as tbuilder
from sskd_tpu_torch.ops import topk as tt
from sskd_tpu_torch.ops import topk_cluster as tcl
from sskd_tpu_torch.ops import topk_kernels as tk
from torch_tc_emulation import binmax_f32, binmax_strided_f32

TOL = 2e-6


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16_case(seed, n=4096, d=64, b=8):
    """(corpus as ml_dtypes bf16, the same as torch bf16, f32 queries)."""
    rng = np.random.default_rng(seed)
    x = _normed(rng, n, d)
    q = x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    xb = x.astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(xb.view(np.int16)).view(torch.bfloat16)
    return xb, xt, q.astype(np.float32)


def test_bf16_conversion_is_ml_dtypes_bit_for_bit():
    """Round to nearest even, ties, subnormals, extremes and infinities: the
    port's conversion through torch equals ml_dtypes' bit for bit."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(10_000).astype(np.float32),
        rng.standard_normal(1000).astype(np.float32) * 1e-39,
        np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 3.4e38, -3.4e38, 1e-45, 0.0, -0.0,
                  np.inf, -np.inf], np.float32),
    ])
    # ties to even at the 16th bit: exact halves between two finite bf16
    ties = (rng.integers(0, 0x7F00, 1000).astype(np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([x, ties])
    got = tbuilder._bf16_bits(x.reshape(1, -1))
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16).reshape(1, -1)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_bf16_binmax_plain_matches_the_jax_binmax_kernel():
    """binmax_plain on bf16 rows gives the bin maxima of the JAX package's
    _binmax_kernel bf16 branch (interpret mode) within 2e-6, a ragged corpus
    and a valid_n that leaves the last bin empty."""
    import functools

    from jax.experimental import pallas as pl

    from sskd_tpu.ops import topk_pallas as tp

    xb, xt, q = _bf16_case(1, n=1000, b=5)
    valid_n, block_rows = 890, 256
    padded = -(-1000 // block_rows) * block_rows
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(tp._binmax_dispatch, has_scales=False, is_int8=False, is_int4=False,
                          block_rows=block_rows),
        grid=(padded // block_rows,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), spec((5, 64), lambda i: (0, 0)),
                  spec((block_rows, 64), lambda i: (i, 0))],
        out_specs=spec((block_rows // 128, 5), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((padded // 128, 5), jnp.float32),
        interpret=True,
    )(jnp.asarray([[valid_n]], jnp.int32), jnp.asarray(q),
      jnp.asarray(np.pad(xb, ((0, padded - 1000), (0, 0)))))
    want = np.asarray(out)[:8]
    q_in, q_scale = tk.quantize_queries(torch.from_numpy(q), xt)
    assert q_in.dtype == torch.float32 and q_scale is None  # the f32 query, unrounded
    got = tk.binmax_plain(q_in, xt, None, valid_n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got[-1] == tk.NEG_INF).all() and (want[-1] == tk.NEG_INF).all()


@pytest.mark.parametrize("B", [1, 3, 8])
def test_bf16_exact_engine_matches_the_jax_pallas_engine(B):
    """The two-phase engine over bf16 rows (binmax_plain, bin_gather_plain)
    against the JAX package's cosine_topk_pallas_impl in interpret mode:
    the same ids, scores within 2e-6."""
    xb, xt, q = _bf16_case(10 + B, b=B)
    jv, ji = cosine_topk_pallas_impl(jnp.asarray(q), jnp.asarray(xb), k=10, block_rows=1024,
                                     valid_n=4090, interpret=True)
    before = (tk.binmax.launches, tk.bin_gather.launches, tk.binmax.bf16_launches)
    tv, ti = tk.cosine_topk_kernels(torch.from_numpy(q), xt, 10, valid_n=4090)
    assert (tk.binmax.launches, tk.bin_gather.launches, tk.binmax.bf16_launches) == before
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)


def test_bf16_bin_gather_plain_scores_widened_rows_against_the_f32_query():
    """bin_gather_plain on bf16 rows: each chosen bin's scores are the f32
    dot of the widened rows with the f32 query (no scale, no rounding of the
    query), the rows past valid_n at the sentinel."""
    xb, xt, q = _bf16_case(2, b=3)
    bins = torch.tensor([[0, 31, 5], [7, 7, 2], [31, 1, 0]], dtype=torch.int32)
    got = tk.bin_gather_plain(torch.from_numpy(q), None, xt, None, bins, 4000).numpy()
    rows = (bins.numpy()[:, :, None] * 128 + np.arange(128)).reshape(3, -1)
    wide = np.asarray(jax.lax.dot_general(jnp.asarray(xb), jnp.asarray(q),
                                          (((1,), (1,)), ((), ())),
                                          preferred_element_type=jnp.float32))  # [N, B]
    want = np.where(rows < 4000, wide[rows, np.arange(3)[:, None]], tk.NEG_INF)
    np.testing.assert_allclose(got.reshape(3, -1), want, rtol=0, atol=TOL)
    with pytest.raises(TypeError, match="queries must be"):
        tk.bin_gather(torch.from_numpy(q).to(torch.bfloat16), None, xt, None, bins)


@pytest.mark.parametrize("blocks", [1, 5])
def test_bf16_strided_pass_matches_jax_scores(blocks):
    """binmax_strided_plain on bf16 rows: the maximum and its row over
    strided bins of the JAX package's f32-query scores over the bf16 rows
    (``_approx_topk``'s dot) within 2e-6, the lower of two equal rows."""
    xb, xt, q = _bf16_case(3, b=3)
    xb[17 + 128 * blocks] = xb[17]
    xt[17 + 128 * blocks] = xt[17]
    q[0] = np.asarray(xb[17], np.float32)
    valid_n = 4000
    scores = np.array(jax.lax.dot_general(jnp.asarray(xb), jnp.asarray(q),
                                          (((1,), (1,)), ((), ())),
                                          preferred_element_type=jnp.float32))
    scores[valid_n:] = tk.NEG_INF
    span = blocks * 128
    pad = -len(scores) % span  # a ragged last round
    want = np.pad(scores, ((0, pad), (0, 0)), constant_values=tk.NEG_INF)
    want = want.reshape(-1, span, 3).max(axis=0)
    top, rows = tk.binmax_strided_plain(torch.from_numpy(q), xt, None, valid_n, blocks)
    np.testing.assert_allclose(top.numpy(), want, rtol=0, atol=TOL)
    picked = scores[rows.numpy().astype(np.int64), np.arange(3)]
    np.testing.assert_allclose(picked, want, rtol=0, atol=TOL)  # each row holds its maximum
    assert int(rows[17, 0]) == 17


@pytest.mark.parametrize("d", [64, 384])
def test_bf16_tile_order_is_within_1e5_of_plain(d):
    """The f32 tile over bf16 rows (the bf16 routes of binmax and
    binmax_strided on the card): each score one fma chain over the widened
    row in order (tests/torch_tc_emulation.py), within the 1e-5 of the plain
    versions that the card's checks allow."""
    xb, xt, q = _bf16_case(4, n=1500, d=d, b=9)
    qt = torch.from_numpy(q)
    got = binmax_f32(qt, xt, None, 1460)
    want = tk.binmax_plain(qt, xt, None, 1460)
    assert (got - want).abs().max().item() <= 1e-5
    top, _ = binmax_strided_f32(qt, xt, None, 1460, 5)
    w_top, _ = tk.binmax_strided_plain(qt, xt, None, 1460, 5)
    assert (top - w_top).abs().max().item() <= 1e-5


def test_bf16_approx_engine_matches_jax():
    """The approx engine over bf16 rows: below its reduction (32 tiles) the
    exact answer on both sides, ids equal; above it (recall_target 0.5 at k
    = 3 needs 3 bins of 128), every id the port returns holds the JAX
    package's score for it."""
    xb, xt, q = _bf16_case(5, b=4)
    jv, ji = jcosine_topk(jnp.asarray(q), jnp.asarray(xb), k=10, method="approx",
                          recall_target=0.95)
    tv, ti = tt.cosine_topk(torch.from_numpy(q), xt, 10, method="approx", recall_target=0.95)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    tv, ti = tt.approx_topk(torch.from_numpy(q), xt, 3, recall_target=0.5)
    wide = np.asarray(xb, np.float32) @ q.T
    np.testing.assert_allclose(tv.numpy(), wide[ti.numpy(), np.arange(4)[:, None]],
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# The cell kernels: the query rounded to bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_cells():
    """16 cells of 256 rows x 64 in bf16, cell-contiguous."""
    rng = np.random.default_rng(6)
    x = _normed(rng, 16 * 256, 64)
    xb = x.astype(ml_dtypes.bfloat16)
    cent = _normed(rng, 16, 64)
    q = _normed(rng, 8, 64)
    return xb, torch.from_numpy(xb.view(np.int16)).view(torch.bfloat16), cent, q


@pytest.mark.parametrize("B", [1, 3, 8])
def test_bf16_cell_scores_match_the_jax_cell_paths(bf16_cells, B):
    """cell_gather_plain / cell_gather_b1_plain on bf16 rows, with the query
    rounded to bf16 (cell_queries), against the JAX package's one-query
    kernel in interpret mode (B = 1) and its XLA cell path (B > 1), which
    round it the same way: within 2e-6."""
    xb, xt, cent, q = bf16_cells
    q = q[:B]
    probe = np.argsort(-(q @ cent.T), axis=1, kind="stable")[:, :5].astype(np.int32)
    q_in, q_scale = tcl.cell_queries(torch.from_numpy(q), xt)
    assert q_in.dtype == torch.bfloat16 and q_scale is None
    q_mat = jnp.asarray(q).astype(jnp.bfloat16)
    np.testing.assert_array_equal(q_in.view(torch.int16).numpy(),
                                  np.asarray(q_mat).view(np.int16))
    if B == 1 and hasattr(pltpu, "force_tpu_interpret_mode"):
        with pltpu.force_tpu_interpret_mode():
            want = jt._cell_scores_pallas_b1(q_mat, None, jnp.asarray(probe), jnp.asarray(xb),
                                             None, 256, 5)
        want = np.asarray(want)
    else:
        want = np.asarray(jt._cell_scores_xla(q_mat, None, jnp.asarray(probe), jnp.asarray(xb),
                                              None, 16, 256, 5, False)).reshape(B, 5, 256)
    wrapper = tcl.cell_gather_b1 if B == 1 else tcl.cell_gather
    before = (wrapper.launches, wrapper.bf16_launches)
    got = wrapper(q_in, None, xt, None, torch.from_numpy(probe), 256)
    assert (wrapper.launches, wrapper.bf16_launches) == before  # a CPU tensor launches nothing
    assert got.shape == (B, 5, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_bf16_clustered_topk_matches_jax(bf16_cells):
    xb, xt, cent, q = bf16_cells
    jv, ji = jt.clustered_topk(jnp.asarray(q), jnp.asarray(xb), jnp.asarray(cent), k=10,
                               nprobe=4, rows_per_cell=256, valid_n=16 * 256 - 7)
    tv, ti = tcl.clustered_topk(torch.from_numpy(q), xt, torch.from_numpy(cent), 10, 4, 256,
                                valid_n=16 * 256 - 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    assert tcl.cell_gather_route(torch.bfloat16, 128) == "bf16"


# ---------------------------------------------------------------------------
# The gate: a corpus on the card goes to the kernels, or the engine raises
# ---------------------------------------------------------------------------


def _on(device, dtype, n=100_000):
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(n, 64))


def test_kernel_gate_takes_bf16_and_refuses_what_no_kernel_takes():
    q = torch.zeros(2, 64)
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
        assert tt.kernel_exact_ok(q, _on("cuda", dtype), 10)
        assert tt.on_card(_on("cuda", dtype))
        assert not tt.kernel_exact_ok(q, _on("cpu", dtype), 10)
    assert not tt.kernel_exact_ok(q, _on("cuda", torch.bfloat16, n=2 * 10 * 128), 10)
    assert not tt.kernel_exact_ok(q, _on("cuda", torch.bfloat16), 257)
    for dtype in (torch.float16, torch.float64, torch.int16):
        with pytest.raises(TypeError, match="no kernel takes"):
            tt.kernel_exact_ok(q, _on("cuda", dtype), 10)
        with pytest.raises(TypeError, match="no kernel takes"):
            tt.approx_topk(q, _on("cuda", dtype), 10)
    for route in (tk.binmax_route, tk.binmax_strided_route, tk.bin_gather_route):
        gather = route is tk.bin_gather_route
        assert route(torch.bfloat16, 768) == ("bf16_tc" if gather else "bf16")
        assert route(torch.int8, 384) == "tc"
        assert route(torch.float32, 1536) == ("f32_tc" if gather else "cuda_core")


def test_bf16_wrappers_refuse_bad_operands():
    xb, xt, q = _bf16_case(7, n=512, b=2)
    with pytest.raises(TypeError, match="queries must be"):
        tk.binmax(torch.from_numpy(q).to(torch.int8), xt)
    with pytest.raises(TypeError, match="float32 / bfloat16 / int8 / uint8"):
        tk.binmax(torch.from_numpy(q), xt.to(torch.float16))
    with pytest.raises(TypeError, match="as the corpus"):
        tcl.cell_gather(torch.from_numpy(q), None, xt, None, torch.zeros((2, 1), dtype=torch.int32),
                        256)
