"""Port vs JAX: the two-phase exact top-k engine.

On the CPU the port's kernel wrappers run their plain torch versions, and the
JAX engine runs its Pallas kernels in interpret mode (block_rows=256). The
same seeded numpy inputs go to both. Ids must be equal; scores agree to 1e-6
relative: int8 / int4 scores are the same integer dot times the same two f32
scales (bit-equal in practice), f32 scores differ only by summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sskd_tpu.ops.quant import quantize_rows as jquant8, quantize_rows_int4 as jquant4
from sskd_tpu.ops.topk_pallas import cosine_topk_pallas
from sskd_tpu_torch.ops import topk as tt
from sskd_tpu_torch.ops import topk_kernels as tk


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


def test_dispatch_gate_and_approx():
    q = torch.zeros(2, 64)
    corpus = torch.zeros(1 << 16, 64, dtype=torch.int8)
    assert tt.kernel_exact_ok(q, corpus, 10) is False  # a CPU corpus never
    with pytest.raises(NotImplementedError, match="approx"):
        tt.cosine_topk(q, corpus, 10, method="approx")
    with pytest.raises(ValueError):
        tk.cosine_topk_kernels(q, corpus, tk.K_MAX + 1)


def test_merge_topk():
    s = torch.tensor([[0.1, 0.9, 0.5, 0.9]])
    i = torch.tensor([[10, 11, 12, 13]])
    v, idx = tt.merge_topk(s, i, 3)
    assert idx.tolist() == [[11, 13, 12]] and v.shape == (1, 3)
