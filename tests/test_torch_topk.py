"""Port vs JAX: the two-phase exact top-k engine and the approx engine.

On the CPU the port's kernel wrappers run their plain torch versions, and the
JAX engine runs its Pallas kernels in interpret mode (block_rows=256). The
same seeded numpy inputs go to both. Ids must be equal; scores agree to 1e-6
relative: int8 / int4 scores are the same integer dot times the same two f32
scales (bit-equal in practice), f32 scores differ only by summation order.

The approx engine: ``lax.approx_max_k`` is exact on the CPU, so the JAX approx
result is the exact one there. The port's reduction is compared with it by
recall (at least the recall target) and by the scores of the ids it returns;
below the reduction threshold and at recall_target 1.0 the ids are equal.
"""

from collections import Counter
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sskd_tpu.ops.quant import quantize_rows as jquant8, quantize_rows_int4 as jquant4
from sskd_tpu.ops.topk import cosine_topk as jcosine_topk
from sskd_tpu.ops.topk_pallas import cosine_topk_pallas
from sskd_tpu_torch.ops import topk as tt
from sskd_tpu_torch.ops import topk_kernels as tk
from torch_tc_emulation import (
    GF_SORT_RUN,
    bin_gather_bf16_tc,
    bin_gather_f32_tc,
    bin_gather_tc,
    binmax_f32,
    binmax_strided_f32,
    binmax_strided_tc,
    binmax_tc,
    mma_tf32,
    packed_tile_dot,
    split_bf16x3,
    unpack_i4_words,
)


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(dtype, x):
    """(numpy corpus, numpy scales or None) in the given storage."""
    if dtype == "f32":
        return x, None
    v, s = (jquant8 if dtype == "int8" else jquant4)(x)
    return np.array(v), np.array(s)


def _both(q, corpus, scales, k, valid_n=None):
    jv, ji = cosine_topk_pallas(
        jnp.asarray(q), jnp.asarray(corpus), k=k, block_rows=256,
        row_scales=None if scales is None else jnp.asarray(scales),
        valid_n=valid_n, interpret=True,
    )
    tv, ti = tk.cosine_topk_kernels(
        torch.from_numpy(q), torch.from_numpy(corpus), k,
        row_scales=None if scales is None else torch.from_numpy(scales),
        valid_n=valid_n,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _assert_same(j, t):
    (jv, ji), (tv, ti) = j, t
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    finite = ji >= 0
    np.testing.assert_allclose(tv[finite], jv[finite], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tv[~finite], jv[~finite])


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
@pytest.mark.parametrize("B,k", [(1, 1), (1, 10), (3, 200), (16, 10)])
def test_engine_matches_jax(dtype, B, k):
    rng = np.random.default_rng(B * 1000 + k)
    corpus, scales = _corpus(dtype, _normed(rng, 1000, 64))  # 8 bins, ragged
    q = _normed(rng, B, 64)
    _assert_same(*_both(q, corpus, scales, k))


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
def test_ragged_valid_n_and_k_beyond_n(dtype):
    rng = np.random.default_rng(7)
    corpus, scales = _corpus(dtype, _normed(rng, 300, 64))
    q = _normed(rng, 3, 64)
    j, t = _both(q, corpus, scales, k=250, valid_n=201)
    _assert_same(j, t)
    assert (t[1][:, 201:] == -1).all() and (t[1][:, :201] < 201).all()


def test_duplicate_winning_bins():
    """The 5 best rows share one bin; the rescan still returns all of them."""
    rng = np.random.default_rng(21)
    corpus = _normed(rng, 1024, 64)
    q = _normed(rng, 1, 64)
    for i in range(5):
        corpus[3 * 128 + 7 + i] = q[0] * (1.0 - 1e-4 * i)
    j, t = _both(q, corpus, None, k=5)
    _assert_same(j, t)
    np.testing.assert_array_equal(t[1][0], 3 * 128 + 7 + np.arange(5))


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
def test_plain_binmax_matches_numpy(dtype):
    rng = np.random.default_rng(3)
    x = _normed(rng, 300, 64)
    corpus, scales = _corpus(dtype, x)
    q = _normed(rng, 4, 64)
    tc = torch.from_numpy(corpus)
    q_in, _ = tk.quantize_queries(torch.from_numpy(q), tc)
    got = tk.binmax(q_in, tc, None if scales is None else torch.from_numpy(scales), 290)
    if dtype == "int4":
        p = corpus.astype(np.int32)
        dense = np.concatenate([(p & 15) - 8, (p >> 4) - 8], axis=1)
    else:
        dense = corpus
    s = dense.astype(np.float64) @ q_in.numpy().astype(np.float64).T
    if scales is not None:
        s = (s.astype(np.float32) * scales[:, None]).astype(np.float64)
    s[290:] = tk.NEG_INF
    s = np.concatenate([s, np.full((384 - 300, 4), tk.NEG_INF)])
    want = s.reshape(3, 128, 4).max(axis=1)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_blocked_engine_matches_kernel_engine():
    rng = np.random.default_rng(5)
    x = _normed(rng, 900, 64)
    q = torch.from_numpy(_normed(rng, 5, 64))
    v, s = (torch.from_numpy(a) for a in _corpus("int8", x))
    kv, ki = tk.cosine_topk_kernels(q, v, 10, row_scales=s, valid_n=850)
    bv, bi = tt.cosine_topk_core(q, v, 10, block_rows=128, row_scales=s, valid_n=850)
    np.testing.assert_array_equal(ki.numpy(), bi.numpy())
    np.testing.assert_array_equal(kv.numpy(), bv.numpy())


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 384, True),
    (torch.float32, 4100, True),     # past one band of 8 staged queries' whole rows
    (torch.float32, 10_000, True),
    (torch.int8, 1040, True),        # over the tensor-core limit: the dp4a kernel
    (torch.bfloat16, 384, True),     # the bf16 routes (the f32 tile over widened rows)
    (torch.bfloat16, 10_000, True),
])
def test_exact_gate_takes_rows_of_any_length(dtype, d, want):
    """On a CUDA corpus the kernel engine takes f32, bf16 and int8 rows of
    any length (the f32 tile stages long rows in bands), so no row length
    sends the caller to the blocked torch engine."""
    corpus = SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=(1 << 16, d))
    assert tt.kernel_exact_ok(torch.zeros(2, d), corpus, 10) is want
    assert tt.kernel_exact_ok(torch.zeros(2, d), corpus, tk.K_MAX + 1) is False


def test_dispatch_gate_and_approx():
    q = torch.zeros(2, 64)
    corpus = torch.zeros(1 << 16, 64, dtype=torch.int8)
    scales = torch.ones(1 << 16)
    assert tt.kernel_exact_ok(q, corpus, 10) is False  # a CPU corpus never
    vals, idx = tt.cosine_topk(q, corpus, 10, row_scales=scales, method="approx")
    assert vals.shape == idx.shape == (2, 10) and idx.dtype == torch.int32
    assert idx[0].tolist() == list(range(10))  # all tied: each bin's first row, the lower bin
    _, idx = tt.cosine_topk(q, corpus[:700], 10, row_scales=scales[:700], method="approx")
    assert idx[0].tolist() == list(range(10))  # 6 tiles, fewer than the bins 0.99 needs: exact
    with pytest.raises(ValueError, match="row_scales"):
        tt.cosine_topk(q, corpus, 10, method="approx")
    with pytest.raises(ValueError, match="recall_target"):
        tt.cosine_topk(q, corpus, 10, row_scales=scales, method="approx", recall_target=0.0)
    with pytest.raises(ValueError, match="unknown method"):
        tt.cosine_topk(q, corpus, 10, row_scales=scales, method="hnsw")
    with pytest.raises(ValueError):
        tk.cosine_topk_kernels(q, corpus, tk.K_MAX + 1)
    assert tt.approx_min_bins(10, 0.99) == pytest.approx(895.5, abs=0.1)
    assert tt.approx_min_bins(10, 1.0) == float("inf") and tt.approx_min_bins(1, 0.5) == 0.0


@pytest.fixture(scope="module")
def wide():
    """200,000 x 32 rows (1,563 bins, past the 896 that k = 10 at 0.99 needs)
    and 64 queries, with JAX's approx result (exact on the CPU) per storage."""
    rng = np.random.default_rng(11)
    x, q = _normed(rng, 200_000, 32), _normed(rng, 64, 32)
    out = {"q": q, "x": x}
    for dtype in ("f32", "int8"):
        corpus, scales = _corpus(dtype, x)
        jv, ji = jcosine_topk(
            jnp.asarray(q), jnp.asarray(corpus), k=10, valid_n=199_990, method="approx",
            row_scales=None if scales is None else jnp.asarray(scales), recall_target=0.99,
        )
        out[dtype] = (corpus, scales, np.asarray(jv), np.asarray(ji))
    return out


def _approx(wide, dtype, **kw):
    corpus, scales, jv, ji = wide[dtype]
    tv, ti = tt.cosine_topk(
        torch.from_numpy(wide["q"]), torch.from_numpy(corpus), 10, valid_n=199_990,
        row_scales=None if scales is None else torch.from_numpy(scales), method="approx", **kw,
    )
    return tv.numpy(), ti.numpy(), jv, ji


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_approx_meets_its_recall_target(wide, dtype):
    tv, ti, jv, ji = _approx(wide, dtype, recall_target=0.99)
    assert ti.dtype == np.int32 and tv.dtype == np.float32 and ti.shape == (64, 10)
    recall = np.mean([len(set(ti[r]) & set(ji[r])) / 10 for r in range(64)])
    assert recall >= 0.99, recall
    assert (np.diff(tv, axis=1) <= 0).all()  # sorted
    assert ((ti >= 0) & (ti < 199_990)).all()
    assert all(len(set(row)) == 10 for row in ti)
    # every returned id carries its true score: the JAX score of that row
    # where JAX returned it too, and the row's own dot in any case
    corpus, scales = wide[dtype][:2]
    for r in range(64):
        both = {int(i): v for i, v in zip(ji[r], jv[r])}
        for i, v in zip(ti[r], tv[r]):
            if int(i) in both:
                np.testing.assert_allclose(v, both[int(i)], rtol=1e-6, atol=1e-7)
    rows = corpus[ti].astype(np.float32)  # [64, 10, D]
    if dtype == "int8":
        qi, qs = jquant8(wide["q"])
        true = np.einsum("bkd,bd->bk", rows, np.asarray(qi, np.float32))
        true = true * np.asarray(qs)[:, None] * scales[ti]
    else:
        true = np.einsum("bkd,bd->bk", rows, wide["q"])
    np.testing.assert_allclose(tv, true, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_approx_at_recall_target_one_is_exact(wide, dtype):
    tv, ti, jv, ji = _approx(wide, dtype, recall_target=1.0)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
def test_approx_below_the_reduction_threshold_is_exact(dtype):
    """8,000 rows are 63 bins, fewer than k = 10 needs at 0.99: both packages
    answer exactly. valid_n and k beyond the corpus keep the sentinels."""
    rng = np.random.default_rng(13)
    corpus, scales = _corpus(dtype, _normed(rng, 8000, 64))
    q = _normed(rng, 4, 64)
    for k, valid_n in ((10, 8000), (10, 7000), (300, 250)):
        jv, ji = jcosine_topk(
            jnp.asarray(q), jnp.asarray(corpus), k=k, valid_n=valid_n, method="approx",
            row_scales=None if scales is None else jnp.asarray(scales),
        )
        tv, ti = tt.cosine_topk(
            torch.from_numpy(q), torch.from_numpy(corpus), k, valid_n=valid_n, method="approx",
            row_scales=None if scales is None else torch.from_numpy(scales),
        )
        _assert_same((np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy()))


def test_approx_masks_the_tail_and_pads():
    """A reducing corpus with five valid rows: the bins that hold no valid
    row never surface, and their sentinel is not scaled into a score."""
    rng = np.random.default_rng(17)
    corpus, scales = _corpus("int8", _normed(rng, 4096, 32))
    q = torch.from_numpy(_normed(rng, 3, 32))
    tv, ti = tt.approx_topk(q, torch.from_numpy(corpus), 8, row_scales=torch.from_numpy(scales),
                            valid_n=5, recall_target=0.5)
    assert sorted(ti[0, :5].tolist()) == [0, 1, 2, 3, 4] and (tv[:, :5] > -2).all()
    assert (ti[:, 5:] == -1).all() and (tv[:, 5:] == tk.NEG_INF).all()
    tv, ti = tt.approx_topk(q, torch.from_numpy(corpus), 5000, row_scales=torch.from_numpy(scales),
                            recall_target=0.5)  # k beyond the corpus: exact, padded
    assert (ti[:, 4096:] == -1).all() and (ti[:, :4096] >= 0).all()


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
@pytest.mark.parametrize("blocks", [1, 3, 6])
def test_plain_binmax_strided(dtype, blocks):
    """Bin j * 128 + t holds the rows (j + i * blocks) * 128 + t: its maximum
    and the first row that holds it, NEG_INF and the bin's first row where no
    row is valid."""
    rng = np.random.default_rng(19)
    x = _normed(rng, 700, 64)
    if blocks < 6:
        x[44 + 128 * blocks] = x[44]  # equal rows in one bin: the lower wins
    corpus, scales = _corpus(dtype, x)
    tc = torch.from_numpy(corpus)
    ts = None if scales is None else torch.from_numpy(scales)
    q_in, _ = tk.quantize_queries(torch.from_numpy(np.concatenate([x[44:45], _normed(rng, 2, 64)])),
                                  tc)
    top, rows = tk.binmax_strided(q_in, tc, ts, 650, blocks)
    assert rows.dtype == torch.int32 and rows.shape == top.shape == (blocks * 128, 3)
    dense = tk._dense_rows(tc, 0, 700) @ q_in.float().T
    if ts is not None:
        dense = dense * ts[:, None]
    dense[650:] = tk.NEG_INF
    for b in range(3):
        for g in range(blocks * 128):
            member = torch.arange(g, max(700, g + 1), blocks * 128)
            member = member[member < 700]
            if len(member) == 0 or dense[member, b].max() <= tk.NEG_INF / 2:
                assert float(top[g, b]) == tk.NEG_INF and int(rows[g, b]) == g
                continue
            best = dense[member, b].max()
            assert float(top[g, b]) == float(best)
            assert int(rows[g, b]) == int(member[torch.nonzero(dense[member, b] == best)[0, 0]])
    assert int(rows[44, 0]) == 44
    with pytest.raises(ValueError, match="blocks"):
        tk.binmax_strided(q_in, tc, ts, 650, 7)


def test_approx_keeps_neighbours_stored_side_by_side():
    """Near neighbours in adjacent rows (one document's chunks; a clustered
    index's cells) must not share a bin: the strided bins keep them apart."""
    rng = np.random.default_rng(23)
    centres = _normed(rng, 400, 32)
    x = np.repeat(centres, 100, axis=0) + 0.05 * rng.standard_normal((40_000, 32)).astype(np.float32)
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # 100 neighbours in a row
    q = torch.from_numpy(centres[:32].copy())
    _, got = tt.cosine_topk(q, torch.from_numpy(x), 10, method="approx", recall_target=0.95)
    _, want = tt.cosine_topk(q, torch.from_numpy(x), 10)
    recall = np.mean([len(set(got[r].tolist()) & set(want[r].tolist())) / 10 for r in range(32)])
    assert recall >= 0.95, recall


# ---------------------------------------------------------------------------
# The tensor-core routes of binmax, binmax_strided and bin_gather, and the
# register-tiled f32 route of binmax and binmax_strided
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route,dtype,row_bytes,want", [
    (tk.binmax_route, torch.int8, 48, "tc"),
    (tk.binmax_route, torch.int8, 384, "tc"),
    (tk.binmax_route, torch.int8, tk.TC_MAX_ROW_BYTES, "tc"),
    (tk.binmax_route, torch.int8, tk.TC_MAX_ROW_BYTES + 16, "cuda_core"),
    (tk.binmax_route, torch.float32, 384 * 4, "cuda_core"),
    (tk.binmax_route, torch.uint8, 192, "tc"),
    (tk.binmax_route, torch.uint8, tk.TC_MAX_ROW_BYTES // 2, "tc"),
    (tk.binmax_route, torch.uint8, tk.TC_MAX_ROW_BYTES // 2 + 16, "cuda_core"),
    (tk.binmax_strided_route, torch.int8, 384, "tc"),
    (tk.binmax_strided_route, torch.int8, tk.TC_MAX_ROW_BYTES, "tc"),
    (tk.binmax_strided_route, torch.int8, tk.TC_MAX_ROW_BYTES + 16, "cuda_core"),
    (tk.binmax_strided_route, torch.float32, 384 * 4, "cuda_core"),
    (tk.binmax_strided_route, torch.uint8, 192, "tc"),
    (tk.binmax_strided_route, torch.uint8, tk.TC_MAX_ROW_BYTES // 2, "tc"),
    (tk.binmax_strided_route, torch.uint8, tk.TC_MAX_ROW_BYTES // 2 + 16, "cuda_core"),
    (tk.bin_gather_route, torch.int8, 384, "tc"),
    (tk.bin_gather_route, torch.int8, tk.TC_MAX_ROW_BYTES, "tc"),
    (tk.bin_gather_route, torch.int8, tk.TC_MAX_ROW_BYTES + 16, "cuda_core"),
    (tk.bin_gather_route, torch.float32, 384 * 4, "f32_tc"),
    (tk.bin_gather_route, torch.float32, 4 * tk.GATHER_F32_TC_MAX_DIM, "f32_tc"),
    (tk.bin_gather_route, torch.float32, 4 * tk.GATHER_F32_TC_MAX_DIM + 16, "cuda_core"),
    (tk.bin_gather_route, torch.uint8, 192, "tc"),
    (tk.bin_gather_route, torch.uint8, tk.TC_MAX_ROW_BYTES // 2, "tc"),
    (tk.bin_gather_route, torch.uint8, tk.TC_MAX_ROW_BYTES // 2 + 16, "cuda_core"),
    (tk.bin_gather_route, torch.bfloat16, 768, "bf16_tc"),
    (tk.bin_gather_route, torch.bfloat16, tk.TC_MAX_ROW_BYTES, "bf16_tc"),
    (tk.bin_gather_route, torch.bfloat16, tk.TC_MAX_ROW_BYTES + 16, "bf16"),
])
def test_topk_kernel_routes(route, dtype, row_bytes, want):
    """int8 rows go to the tensor cores, and packed int4 rows of at most
    512 bytes (D <= 1,024); bin_gather's bf16 rows of at most 1,024 bytes
    (D <= 512) to its split-query tensor-core kernel, longer ones to the
    CUDA cores' bf16 mode; bin_gather's f32 rows of at most 1,024 floats to
    its three-TF32-product kernel; binmax's and binmax_strided's f32 rows,
    and rows over a route's limit, to the CUDA-core kernels."""
    assert route(dtype, row_bytes) == want


def _int8_case(seed, n, d, B):
    rng = np.random.default_rng(seed)
    x = _normed(rng, n, d)
    return x, _normed(rng, B, d)


@pytest.mark.parametrize("n,valid_n,blocks,B,d", [
    (3000, 3000, 7, 1, 64),      # 24 tiles: 7 blocks do not divide them
    (3000, 2950, 5, 5, 64),      # the last tile holds no valid row
    (2800, 2700, 22, 64, 48),    # one tile a block, rows of 48 bytes (a zero tail)
    (3000, 2999, 3, 65, 64),     # two query chunks, the second of one query
    (1100, 1100, 9, 16, 96),     # every block one tile, the last ragged
])
def test_tensor_core_binmax_strided_traversal_is_bit_for_bit(n, valid_n, blocks, B, d):
    """The tensor-core strided pass (tests/torch_tc_emulation.py: the warps'
    row positions, the tiles in increasing order, queries in chunks of 64,
    the running best) gives binmax_strided_plain's maxima and rows bit for
    bit, equal rows in one bin keeping the lower."""
    x, q = _int8_case(n + blocks, n, d, B)
    for t, i in ((40, 1), (41, 2)):  # ties in bins 40 and 41, where the bin has the rows
        if t + 128 * blocks * i < n:
            x[t + 128 * blocks * i] = x[t]
    q[0] = x[40]
    xq, xs = (torch.from_numpy(np.array(a)) for a in jquant8(x))
    q_in, _ = tk.quantize_queries(torch.from_numpy(q), xq)
    got, rows = binmax_strided_tc(q_in, xq, xs, valid_n, blocks)
    want, want_rows = tk.binmax_strided_plain(q_in, xq, xs, valid_n, blocks)
    assert torch.equal(got, want) and torch.equal(rows, want_rows)
    assert int(rows[40, 0]) == 40  # the tie: the lower row
    dead = got <= tk.NEG_INF / 2  # a bin of no valid row: its first row
    first = torch.arange(blocks * 128, dtype=torch.int32)[:, None].expand_as(rows)
    assert torch.equal(rows[dead], first[dead])


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("B,kb", [(1, 1), (1, 12), (5, 12), (64, 1), (64, 12), (65, 12)])
def test_tensor_core_bin_gather_traversal_is_bit_for_bit(B, kb, sort):
    """The tensor-core bin gather (tests/torch_tc_emulation.py: 16-row tiles,
    the valid_n mask, the ragged last bin read as zeros, the pairs in their
    own order or sorted by bin) gives bin_gather_plain's scores bit for bit,
    with every (query, slot) pair scored; sorted, each distinct bin is
    loaded once."""
    n, d, valid_n = 1900, 64, 1850  # 15 bins, the last of 108 rows
    x, q = _int8_case(B * 100 + kb, n, d, B)
    xq, xs = (torch.from_numpy(np.array(a)) for a in jquant8(x))
    q_in, q_scale = tk.quantize_queries(torch.from_numpy(q), xq)
    rng = np.random.default_rng(B + kb)
    bins = np.stack([rng.permutation(15)[:kb] for _ in range(B)]).astype(np.int32)
    bins[: max(1, B // 2), 0] = 14  # the ragged last bin, shared by half the queries
    bins = torch.from_numpy(bins)
    got, loads = bin_gather_tc(q_in, q_scale, xq, xs, bins, valid_n, sort=sort)
    want = tk.bin_gather_plain(q_in, q_scale, xq, xs, bins, valid_n)
    assert torch.equal(got, want)  # no NaN left: every pair scored
    assert (got[:, :, 1850 - 14 * 128:][bins == 14] == tk.NEG_INF).all()
    if sort:
        assert set(loads.values()) == {1}
        assert sorted(loads) == sorted(set(bins.reshape(-1).tolist()))


def _jax_gather(q_in, q_scale, corpus, scales, bins, valid_n):
    """The JAX package's _gather_kernel through its own pallas_call, in
    interpret mode: scores [B, kb, 128] of the rows of ``bins`` [B, kb], one
    grid step a query with its kb bins as operands; int8 queries as f32
    with their scales [B] for int8 and packed int4 rows, f32 queries for
    bf16 rows (ml_dtypes bfloat16)."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from sskd_tpu.ops import topk_pallas as tp

    B, d = q_in.shape
    kb = bins.shape[1]
    n, dc = corpus.shape
    padded = -(-n // 128) * 128
    corpus = np.pad(corpus, ((0, padded - n), (0, 0)))
    quantized = corpus.dtype in (np.int8, np.uint8)
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)

    def bin_spec(jj, width):
        return vmem((128, width), functools.partial(
            lambda b, j, bins, valid, _jj: (bins[b, _jj], 0), _jj=jj))

    specs = [vmem((B, d), lambda b, j, bins, valid: (0, 0)),
             vmem((B, 1), lambda b, j, bins, valid: (0, 0))]
    operands = [jnp.asarray(q_in, jnp.float32),
                jnp.asarray(q_scale.reshape(B, 1) if quantized else np.ones((B, 1), np.float32))]
    specs += [bin_spec(jj, dc) for jj in range(kb)]
    operands += [jnp.asarray(corpus)] * kb
    if scales is not None:
        specs += [bin_spec(jj, 1) for jj in range(kb)]
        operands += [jnp.asarray(np.pad(scales, (0, padded - n)).reshape(padded, 1))] * kb
    out = pl.pallas_call(
        functools.partial(tp._gather_kernel, has_scales=scales is not None,
                          is_int8=corpus.dtype == np.int8, is_int4=corpus.dtype == np.uint8),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2, grid=(B, 1), in_specs=specs,
            out_specs=vmem((1, kb, 128), lambda b, j, bins, valid: (b, j, 0))),
        out_shape=jax.ShapeDtypeStruct((B, kb, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(bins), jnp.asarray([valid_n], jnp.int32), *operands)
    return np.asarray(out)


def _gather_bins(seed, B, kb, n_bins):
    """Seeded distinct bins [B, kb] int32, the ragged last bin shared by half
    the queries."""
    rng = np.random.default_rng(seed)
    bins = np.stack([rng.permutation(n_bins)[:kb] for _ in range(B)]).astype(np.int32)
    bins[: max(1, B // 2), 0] = n_bins - 1
    return torch.from_numpy(bins)


@pytest.mark.parametrize("n,valid_n,B,kb,d", [
    (1900, 1900, 1, 12, 64),     # a ragged last bin (108 rows), rows of 32 packed bytes
    (1900, 1850, 5, 12, 96),     # 48 packed bytes (16 mod 32), valid_n cuts the last bin
    (1300, 1250, 9, 7, 1024),    # the longest packed row (512 bytes), two 8-query groups
    (2000, 1920, 3, 16, 32),     # 16 packed bytes, the last bin holds no valid row
])
def test_tensor_core_int4_bin_gather_is_bit_for_bit(n, valid_n, B, kb, d):
    """Packed int4 rows through the tensor-core bin gather
    (tests/torch_tc_emulation.py ``bin_gather_tc``: each packed step
    unpacked into two s8 fragments against the query halves, each half's
    lanes past its bytes zero, rows past the corpus read as zero bytes, -8
    in every dim, and masked) give bin_gather_plain's scores bit for bit,
    and so does the JAX package's _gather_kernel int4 branch (interpret
    mode)."""
    x, q = _int8_case(n + B + d, n, d, B)
    xq, xs = (np.array(a) for a in jquant4(x))
    packed, scales = torch.from_numpy(xq), torch.from_numpy(xs)
    q_in, q_scale = tk.quantize_queries(torch.from_numpy(q), packed)
    n_bins = -(-n // 128)
    bins = _gather_bins(n * B + kb, B, kb, n_bins)
    got, _ = bin_gather_tc(q_in, q_scale, packed, scales, bins, valid_n)
    want = tk.bin_gather_plain(q_in, q_scale, packed, scales, bins, valid_n)
    assert torch.equal(got, want)  # no NaN left: every pair scored
    jax_got = _jax_gather(q_in.numpy(), q_scale.numpy(), xq, xs, bins.numpy(), valid_n)
    np.testing.assert_array_equal(jax_got, want.numpy())
    rows = bins.long()[:, :, None] * 128 + torch.arange(128)
    assert ((got == tk.NEG_INF) == (rows >= valid_n)).all()


@pytest.mark.parametrize("kind", ["seeded", "zeros", "bf16_values", "small"])
def test_split_query_terms_are_exact(kind):
    """The f32 query's three bf16 terms (csrc/mma_common.cuh ``bf16_term``,
    tests/torch_tc_emulation.py ``split_bf16x3``) are bf16 values that sum
    to the query exactly, bit for bit, in f32 and in float64: over seeded
    values, zeros (every term 0), exact bf16 values (t1 = t2 = 0) and small
    magnitudes."""
    rng = np.random.default_rng(5)
    x = {"seeded": rng.standard_normal(20_000) * 10.0 ** rng.integers(-6, 7, 20_000),
         "zeros": np.zeros(64),
         "bf16_values": rng.standard_normal(4096).astype(ml_dtypes.bfloat16).astype(np.float64),
         "small": rng.standard_normal(4096) * 1e-30}[kind]
    x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    terms = split_bf16x3(x)
    for t in terms:
        assert torch.equal(t.to(torch.bfloat16).float(), t)  # each a bf16 value
    assert torch.equal((terms[0] + terms[1]) + terms[2], x)
    total = terms[0].double() + terms[1].double() + terms[2].double()
    assert torch.equal(total, x.double())
    if kind in ("zeros", "bf16_values"):
        assert torch.equal(terms[1], torch.zeros_like(x)) and torch.equal(terms[2], terms[1])


@pytest.mark.parametrize("n,valid_n,B,kb,d,scaled", [
    (1900, 1850, 3, 12, 64, False),    # a ragged last bin cut by valid_n
    (1300, 1300, 2, 5, 512, False),    # the longest row of the route (1,024 bytes)
    (2000, 1920, 4, 9, 40, True),      # 80-byte rows (a zero tail), scales
])
def test_split_query_bf16_gather_within_1e5(n, valid_n, B, kb, d, scaled):
    """The bf16 tensor-core bin gather (tests/torch_tc_emulation.py
    ``bin_gather_bf16_tc``: the f32 query as three bf16 terms in one mma a
    16-dim step, each step's sum truncated to f32, each score (c2 + c1) +
    c0) stays within the 1e-5 that the card's checks allow of
    bin_gather_plain and of the JAX package's _gather_kernel bf16 branch
    (interpret mode), with rows past valid_n at the sentinel."""
    x, q = _int8_case(n + d + B, n, d, B)
    xb = x.astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(xb.view(np.int16)).view(torch.bfloat16)
    qt = torch.from_numpy(q)
    scales = (np.random.default_rng(d).uniform(0.5, 2.0, n).astype(np.float32)
              if scaled else None)
    st = torch.from_numpy(scales) if scaled else None
    bins = _gather_bins(n + kb, B, kb, -(-n // 128))
    got = bin_gather_bf16_tc(qt, xt, st, bins, valid_n)
    want = tk.bin_gather_plain(qt, None, xt, st, bins, valid_n)
    dead = want == tk.NEG_INF
    assert torch.equal(got == tk.NEG_INF, dead)
    assert (got - want).abs().max().item() <= 1e-5
    jax_got = _jax_gather(q, None, xb, scales, bins.numpy(), valid_n)
    assert np.abs(got.numpy() - jax_got).max() <= 1e-5
    # the split carries the f32 query: rounding it to bf16 moves scores further
    rounded = tk.bin_gather_plain(qt.to(torch.bfloat16).float(), None, xt, st, bins, valid_n)
    assert (rounded - want).abs().max().item() > 10 * (got - want).abs().max().item()


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n,valid_n,B,kb,d,scaled", [
    (1900, 1900, 1, 4, 32, False),     # a ragged last bin (108 rows), one query
    (1900, 1850, 3, 3, 384, True),     # valid_n cuts the ragged last bin; scales
    (2000, 1920, 16, 2, 32, False),    # the last bin holds no valid row
    (1300, 1300, 16, 4, 384, True),    # 64 pairs over 11 bins: the sorted runs share them
    (700, 650, 3, 1, 100, False),      # a partial last chunk of 32 floats
])
def test_f32_tensor_core_bin_gather_within_1e5(n, valid_n, B, kb, d, scaled, sort):
    """The f32 tensor-core bin gather (tests/torch_tc_emulation.py
    ``bin_gather_f32_tc``: three TF32 products a product, f32 sums over
    8-deep steps, the pairs in their own order or sorted by bin, each group
    of equal bins reading its bin once) stays within the 1e-5 that the card
    allows of bin_gather_plain and of the JAX package's _gather_kernel f32
    branch (interpret mode) on unit rows, with the sentinel where they have
    it and every pair scored; sorted, a bin is read once a run."""
    x, q = _int8_case(n + B + d + kb, n, d, B)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    scales = (np.random.default_rng(d).uniform(0.5, 2.0, n).astype(np.float32)
              if scaled else None)
    st = torch.from_numpy(scales) if scaled else None
    bins = _gather_bins(n + kb, B, kb, -(-n // 128))
    got, loads = bin_gather_f32_tc(qt, xt, st, bins, valid_n, sort=sort)
    want = tk.bin_gather_plain(qt, None, xt, st, bins, valid_n)
    assert not torch.isnan(got).any()
    assert torch.equal(got == tk.NEG_INF, want == tk.NEG_INF)
    assert (got - want).abs().max().item() <= 1e-5
    jax_got = _jax_gather(q, None, x, scales, bins.numpy(), valid_n)
    assert np.abs(got.numpy() - jax_got).max() <= 1e-5
    pairs_of = Counter(bins.reshape(-1).tolist())
    if sort:  # each distinct bin read once a run of GF_SORT_RUN sorted entries it falls in
        ordered = sorted(bins.reshape(-1).tolist())
        assert loads == Counter(b for i in range(0, len(ordered), GF_SORT_RUN)
                                for b in set(ordered[i:i + GF_SORT_RUN]))
    else:
        assert loads == pairs_of
    # three TF32 products carry the f32 product: one TF32 pass moves scores further
    one_pass = mma_tf32(xt, qt.T, passes=1).T
    exact = (xt.double() @ qt.double().T).T
    assert (one_pass - exact).abs().max().item() > 10 * (got - want).abs().max().item()


@pytest.mark.parametrize("n_pairs,n_rows,want", [
    (16 * 10, 1_000_000, "own"),      # an f32 index's /search: pairs rarely share a bin
    (256 * 10, 1_000_000, "own"),     # 0.33 pairs a bin of the 7,813
    (256 * 30, 1_000_000, "sorted"),  # 0.98
    (1000 * 20, 8192, "sorted"),      # the evaluator: 312 pairs a bin
    (32, 8192, "sorted"),             # the threshold: half a pair a bin of 64
    (31, 8192, "own"),
])
def test_f32_bin_gather_layout_rule(n_pairs, n_rows, want):
    """The f32 route sorts its pairs by bin from GATHER_F32_SORT_PAIRS_PER_BIN
    pairs a bin of the corpus on."""
    assert tk.GATHER_F32_SORT_PAIRS_PER_BIN == 0.5
    assert tk.bin_gather_f32_layout(n_pairs, n_rows) == want


@pytest.mark.parametrize("n_rows", [1900, 2**15 * 128, 2**15 * 128 + 1])
def test_bin_order_is_the_stable_sort_by_bin(n_rows):
    """bin_order gives the pairs sorted by bin, a bin's pairs in their own
    order, whether the keys go to 16 bits (bins below 2^15) or stay 32."""
    rng = np.random.default_rng(n_rows % 1000)
    n_bins = -(-n_rows // 128)
    bins = torch.from_numpy(rng.integers(0, n_bins, (37, 9)).astype(np.int32))
    bins[3, :4] = n_bins - 1
    want = sorted(range(bins.numel()), key=lambda i: (int(bins.view(-1)[i]), i))
    assert tk.bin_order(bins, n_rows).tolist() == want


def test_exact_engine_at_b64_int8_matches_jax():
    """The exact engine at the batch the serve load reaches, int8 rows and
    a ragged valid_n: the port's plain engine gives the JAX package's ids,
    through its Pallas kernels in interpret mode and through cosine_topk."""
    rng = np.random.default_rng(64)
    x = _normed(rng, 3000, 64)
    corpus, scales = _corpus("int8", x)
    q = (x[rng.choice(2900, 64, replace=False)]
         + 0.05 * rng.standard_normal((64, 64)).astype(np.float32))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    j, t = _both(q, corpus, scales, k=10, valid_n=2901)
    _assert_same(j, t)
    _, ji = jcosine_topk(jnp.asarray(q), jnp.asarray(corpus), 10,
                         row_scales=jnp.asarray(scales), valid_n=2901)
    np.testing.assert_array_equal(t[1], np.asarray(ji))
    assert (t[1] < 2901).all()


@pytest.mark.parametrize("n,valid_n,B,d,units", [
    (1000, 1000, 1, 64, 2),      # a ragged last bin (104 rows)
    (1000, 890, 5, 48, 1),       # the last bin holds no valid row; rows of 48 bytes
    (1000, 950, 8, 64, 3),       # a ragged valid_n inside the ragged last bin
    (2000, 1999, 9, 384, 2),     # two query groups, the second of one query
    (1300, 1250, 64, 1024, 1),   # a whole chunk of 64 at the longest row
    (1100, 1100, 65, 384, 4),    # two chunks, the second of one query
])
def test_tensor_core_binmax_traversal_is_bit_for_bit(n, valid_n, B, d, units):
    """The tensor-core binmax (tests/torch_tc_emulation.py: units of four
    warps walking bins of 128 contiguous rows as eight 16-row tiles, queries
    in chunks of 64, the masked running maximum in the C-fragment layout and
    its reduction over the row halves and the grp lanes) gives binmax_plain's
    maxima bit for bit, every column of every bin written; a bin of no valid
    row gives NEG_INF."""
    x, q = _int8_case(n * 7 + B, n, d, B)
    xq, xs = (torch.from_numpy(np.array(a)) for a in jquant8(x))
    q_in, _ = tk.quantize_queries(torch.from_numpy(q), xq)
    got = binmax_tc(q_in, xq, xs, valid_n, units)
    want = tk.binmax_plain(q_in, xq, xs, valid_n)
    assert got.shape == want.shape == ((n + 127) // 128, B)
    assert torch.equal(got, want)  # no NaN left: every (bin, query) written
    dead = torch.arange(got.shape[0]) * 128 >= valid_n
    assert (got[dead] == tk.NEG_INF).all() and (got[~dead] > tk.NEG_INF).all()


@pytest.mark.parametrize("n,valid_n,B,d,units,blocks", [
    (1000, 950, 8, 64, 3, 7),      # one 8-query group; rows of 32 packed bytes
    (2000, 1999, 65, 96, 2, 3),    # two chunks; 48 packed bytes, a zero tail a row
    (1300, 1250, 16, 1024, 1, 11),  # the longest packed row (512 bytes)
])
def test_tensor_core_int4_walks_are_bit_for_bit(n, valid_n, B, d, units, blocks):
    """Packed int4 rows through the tensor-core walks of binmax and
    binmax_strided (tests/torch_tc_emulation.py: each packed step unpacked
    into two s8 fragments, rows past the corpus read as zero bytes, -8 in
    every dim, and masked) give binmax_plain's and binmax_strided_plain's
    results bit for bit."""
    x, q = _int8_case(n + B + d, n, d, B)
    xq, xs = (torch.from_numpy(np.array(a)) for a in jquant4(x))
    q_in, _ = tk.quantize_queries(torch.from_numpy(q), xq)
    got = binmax_tc(q_in, xq, xs, valid_n, units)
    assert torch.equal(got, tk.binmax_plain(q_in, xq, xs, valid_n))
    s_got, s_rows = binmax_strided_tc(q_in, xq, xs, valid_n, blocks)
    s_want, s_want_rows = tk.binmax_strided_plain(q_in, xq, xs, valid_n, blocks)
    assert torch.equal(s_got, s_want) and torch.equal(s_rows, s_want_rows)


def _jax_binmax(q_in, corpus, scales, valid_n, block_rows=256):
    """The JAX package's _binmax_kernel through its own pallas_call, in
    interpret mode: bin maxima [ceil(N / 128), B] without the query scale,
    over int8 rows or packed int4 rows (uint8, the halves layout)."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from sskd_tpu.ops import topk_pallas as tp

    n, dc = corpus.shape
    B, d = q_in.shape
    is_int4 = corpus.dtype == np.uint8
    padded = -(-n // block_rows) * block_rows
    corpus = np.pad(corpus, ((0, padded - n), (0, 0)))
    scales = np.pad(scales, (0, padded - n)).reshape(padded, 1)
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(tp._binmax_dispatch, has_scales=True, is_int8=not is_int4,
                          is_int4=is_int4, block_rows=block_rows),
        grid=(padded // block_rows,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  spec((B, d), lambda i: (0, 0)),
                  spec((block_rows, dc), lambda i: (i, 0)),
                  spec((block_rows, 1), lambda i: (i, 0))],
        out_specs=spec((block_rows // 128, B), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((padded // 128, B), jnp.float32),
        interpret=True,
    )(jnp.asarray([[valid_n]], jnp.int32), jnp.asarray(q_in), jnp.asarray(corpus),
      jnp.asarray(scales))
    return np.asarray(out)[: -(-n // 128)]


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_plain_binmax_matches_the_jax_binmax_kernel(dtype):
    """binmax_plain, which the tensor-core route matches bit for bit, gives
    the JAX package's _binmax_kernel maxima (interpret mode) bit for bit at
    int8 and packed int4, a ragged corpus and a valid_n that leaves the last
    bin empty; so does the emulated tensor-core walk
    (tests/torch_tc_emulation.py ``binmax_tc``: int4 unpacked a packed step
    at a time, rows of 48 packed bytes, a zero-filled tail in each step)."""
    x, q = _int8_case(77, 1000, 96 if dtype == "int4" else 64, 9)
    xq, xs = (np.array(a) for a in (jquant4 if dtype == "int4" else jquant8)(x))
    q_in, _ = tk.quantize_queries(torch.from_numpy(q), torch.from_numpy(xq))
    want = tk.binmax_plain(q_in, torch.from_numpy(xq), torch.from_numpy(xs), 890).numpy()
    got = _jax_binmax(q_in.numpy(), xq, xs, 890)
    np.testing.assert_array_equal(got, want)
    assert (want[-1] == tk.NEG_INF).all()
    walked = binmax_tc(q_in, torch.from_numpy(xq), torch.from_numpy(xs), 890, 2).numpy()
    np.testing.assert_array_equal(walked, got)


def test_int4_fragment_unpack_matches_the_jax_nibbles():
    """The tensor-core kernels' unpack of a packed step (csrc/mma_common.cuh
    ``unpack_i4`` on the 32-bit registers of an ldmatrix fragment) gives, for
    each of the 256 byte values in each byte of a register, 16 times the JAX
    package's nibble values (``_unpack_nibbles``): the low nibble into the
    fragment of the first half of the dims, the high one into the second."""
    from sskd_tpu.ops.topk_pallas import _unpack_nibbles

    from torch_tc_emulation import _s8_bytes, _words

    values = np.arange(256, dtype=np.uint8)
    j_lo, j_hi = (np.asarray(a).astype(np.int64) for a in _unpack_nibbles(jnp.asarray(values)))
    for shift in range(4):  # the value in every byte position of a register
        rows = torch.from_numpy(np.roll(values, shift).astype(np.int64))[None]
        lo, hi = (_s8_bytes(w)[0].numpy() for w in unpack_i4_words(_words(rows)))
        np.testing.assert_array_equal(lo, 16 * np.roll(j_lo, shift))
        np.testing.assert_array_equal(hi, 16 * np.roll(j_hi, shift))


@pytest.mark.parametrize("half", [16, 48, 192, 512])
def test_packed_tile_dot_is_the_unpacked_dot(half):
    """The emulated mma over a packed tile (two mma a 32-byte step, the rows
    zero-filled to the step count, a half of 16 mod 32 bytes leaving a zero
    tail in the last step, the 16-fold sums shifted back) equals
    ``unpack_int4(packed) @ q`` exactly, at the extremes of the int4 and
    int8 values too."""
    from sskd_tpu_torch.ops.quant import unpack_int4

    rng = np.random.default_rng(half)
    packed = torch.from_numpy(rng.integers(0, 256, (16, half), dtype=np.uint8))
    packed[0] = 0x00  # every value -8
    packed[1] = 0xFF  # every value 7
    q = torch.from_numpy(rng.integers(-127, 128, (8, 2 * half), dtype=np.int8))
    q[0] = -127
    want = unpack_int4(packed).to(torch.int64) @ q.to(torch.int64).T
    assert torch.equal(packed_tile_dot(packed.to(torch.int64), q), want)


def test_plain_strided_int4_pass_is_the_int8_pass_over_unpacked_rows():
    """binmax_strided_plain over packed int4 rows gives, bit for bit, the
    int8 plain pass over the same rows unpacked by the JAX package
    (``_unpack_nibbles``, halves layout), maxima and rows; the emulated
    tensor-core strided pass gives the same over the packed rows."""
    from sskd_tpu.ops.topk_pallas import _unpack_nibbles

    n, valid_n, blocks, B = 2300, 2250, 5, 17  # a ragged last tile, two 8-query groups
    x, q = _int8_case(31, n, 96, B)
    xq, xs = (np.array(a) for a in jquant4(x))
    lo, hi = (np.asarray(a) for a in _unpack_nibbles(jnp.asarray(xq)))
    unpacked = torch.from_numpy(np.concatenate([lo, hi], axis=1))
    packed, scales = torch.from_numpy(xq), torch.from_numpy(xs)
    q_in, _ = tk.quantize_queries(torch.from_numpy(q), packed)
    got, rows = tk.binmax_strided_plain(q_in, packed, scales, valid_n, blocks)
    want, want_rows = tk.binmax_strided_plain(q_in, unpacked, scales, valid_n, blocks)
    assert torch.equal(got, want) and torch.equal(rows, want_rows)
    walked, walked_rows = binmax_strided_tc(q_in, packed, scales, valid_n, blocks)
    assert torch.equal(walked, got) and torch.equal(walked_rows, rows)


@pytest.mark.parametrize("d", [384, 1024, 10_000])
@pytest.mark.parametrize("scaled", [False, True])
def test_f32_tile_order_is_within_1e5_of_plain(d, scaled):
    """The f32 kernels' summation order (one fma chain a score over the row
    in order, tests/torch_tc_emulation.py; rows staged in bands keep it)
    stays within the 1e-5 that the card's checks allow of binmax_plain and
    binmax_strided_plain, and the strided pass keeps the lower of two equal
    rows in one bin."""
    n, valid_n, B, blocks = 1500, 1460, 9, 5
    x, q = _int8_case(d + scaled, n, d, B)
    x[17 + 128 * blocks] = x[17]  # equal rows in bin 17: the lower wins
    q[0] = x[17]
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    scales = np.random.default_rng(d).uniform(0.5, 2.0, n).astype(np.float32)
    scales[17 + 128 * blocks] = scales[17]
    scales = torch.from_numpy(scales)
    sc = scales if scaled else None
    got = binmax_f32(qt, xt, sc, valid_n)
    want = tk.binmax_plain(qt, xt, sc, valid_n)
    assert got.shape == want.shape and (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got <= tk.NEG_INF / 2, want <= tk.NEG_INF / 2)
    top, rows = binmax_strided_f32(qt, xt, sc, valid_n, blocks)
    w_top, w_rows = tk.binmax_strided_plain(qt, xt, sc, valid_n, blocks)
    assert (top - w_top).abs().max().item() <= 1e-5
    assert (rows == w_rows).float().mean().item() >= 0.9999
    assert int(rows[17, 0]) == 17
