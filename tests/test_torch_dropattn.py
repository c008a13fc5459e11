"""Port vs JAX: training attention, and the keep-mask generator.

On the CPU the port's dropattn wrappers run their plain versions. At p = 0
they are held against the JAX ``dropout_attention`` in interpret mode
(forward and q/k/v gradients). At p > 0 no GPU reproduces the TPU's
generator, so the port's own mask is tested for its properties, and the
plain backward against autograd through an explicit-mask attention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sskd_tpu.ops.attention import _dropattn_bwd_call as j_dropattn_bwd
from sskd_tpu.ops.attention import _dropattn_fwd_call as j_dropattn_fwd
from sskd_tpu.ops.attention import dropout_attention as j_dropattn
from sskd_tpu.ops.attention import scaled_dot_attention as j_sda
from sskd_tpu_torch.ops import attention as ta
from torch_tc_emulation import (
    dropattn_bwd_tc_3pass,
    dropattn_bwd_tc,
    dropattn_bwd_tf32,
    dropattn_fwd_tc,
    dropattn_fwd_tf32,
    tf32_forward_fragment_keys,
    tf32_fragment_keys,
)

NEG = float(np.finfo(np.float32).min / 2)


def _inputs(seed, B, h, L, d):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, h, L, d)).astype(np.float32) for _ in range(4))
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    bias = np.where(np.arange(L)[None, :] < lens[:, None], 0.0, NEG).astype(np.float32)
    return q, k, v, g, bias


def _jax_fwd_grads(q, k, v, g, bias, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]

    def f(a, b, c):
        out = j_dropattn(a, b, c, jnp.asarray(bias), 0.0, jnp.int32(3), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_fwd_grads(q, k, v, g, bias, dtype, p=0.0, seed=3):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = ta.dropout_attention(*leaves, torch.from_numpy(bias), p, seed)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dtype))
    return [x.float().numpy() for x in (out.detach(), *grads)]


# f32: summation order through two products and the softmax over <= 48 keys.
# bf16: both sides round q, k, v, the probabilities, ds and the results to
# bf16 (2^-8 relative each), and XLA rounds in other places than torch; at
# these magnitudes (outputs O(1), gradients O(10)) a few bf16 ulps of the
# largest element: 0.05 absolute plus 2% relative.
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 3e-5, 0.0), ("bfloat16", 5e-2, 2e-2)])
@pytest.mark.parametrize("L", [16, 48])
def test_dropout_attention_p0_matches_jax(dtype, atol, rtol, L):
    q, k, v, g, bias = _inputs(L, 2, 3, L, 16)
    want = _jax_fwd_grads(q, k, v, g, bias, getattr(jnp, dtype))
    got = _port_fwd_grads(q, k, v, g, bias, getattr(torch, dtype))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("L", [64, 130])
def test_dropout_attention_f32_p0_matches_jax_at_head_dim_16(L):
    """The head dim of BertConfig.tiny (hidden 64, 4 heads), which the
    pipeline's --tiny student and teacher train at: the plain pair the
    wrappers run on the CPU against the JAX dropout_attention in interpret
    mode at p = 0, forward and q, k, v gradients, each within 1e-5
    (1 + |want|)."""
    q, k, v, g, bias = _inputs(L + 16, 2, 4, L, 16)
    want = _jax_fwd_grads(q, k, v, g, bias, jnp.float32)
    got = _port_fwd_grads(q, k, v, g, bias, torch.float32)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert (np.abs(a - b) / (1 + np.abs(b))).max() <= 1e-5, name


def test_flash_gradient_matches_jax_at_512():
    """scaled_dot_attention at L = 512 takes the flash path in the port; its
    gradient is the plain VJP on the same bias, against JAX's attention
    gradient (f32, summation order: 1e-5)."""
    q, k, v, g, bias = _inputs(512, 2, 2, 512, 16)
    bias4 = bias[:, None, None, :]

    def f(a, b, c):
        return jnp.sum(j_sda(a, b, c, jnp.asarray(bias4)) * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ta.scaled_dot_attention(*leaves, torch.from_numpy(bias4))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_flash_gradient_survives_a_kernel_output_without_graph(monkeypatch):
    """On the card the flash kernel writes into a fresh tensor through ctypes,
    so its output has no autograd graph. Standing in for it with a detached
    plain result, the dispatcher's gradient must still reach q, k and v."""
    plain = ta.flash_attention_plain
    monkeypatch.setattr(ta, "flash_attention",
                        lambda q, k, v, mask=None: plain(q, k, v, mask).detach())
    q, k, v, g, bias = _inputs(7, 1, 2, 512, 16)
    bias4 = torch.from_numpy(bias[:, None, None, :])
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(ta.scaled_dot_attention(*leaves, bias4), leaves,
                              torch.from_numpy(g))
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ta.plain_attention(*ref, bias4), ref, torch.from_numpy(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10 (kat_vectors)."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        t = lambda x: torch.tensor([x], dtype=torch.int64)  # noqa: E731
        got = ta.philox4x32(t(ctr[0]), t(ctr[1]), key[0], t(key[1]), ctr[2], ctr[3])
        assert tuple(int(w) for w in got) == want


def test_keep_rate_is_within_five_sigma():
    mask = ta.dropout_keep_mask(2024, 48, 128, 0.1)
    n = mask.numel()
    sigma = (n * 0.9 * 0.1) ** 0.5
    assert abs(int(mask.sum()) - 0.9 * n) <= 5 * sigma


def test_mask_is_a_function_of_seed_head_row_col():
    full = ta.dropout_keep_mask(5, 12, 96, 0.1)
    assert bool((full == ta.dropout_keep_mask(5, 12, 96, 0.1)).all())
    other = ta.dropout_keep_mask(6, 12, 96, 0.1)
    assert (full != other).float().mean().item() > 0.1
    # a block of heads, and a shorter length, are slices of the full mask
    part = ta.dropout_uniform(5, 4, 3, 96) >= 0.1
    assert bool((part == full[4:7]).all())
    short = ta.dropout_keep_mask(5, 12, 37, 0.1)
    assert bool((short == full[:, :37, :37]).all())


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
def test_plain_backward_equals_autograd_through_the_explicit_mask(p):
    q, k, v, g, bias = _inputs(11, 2, 3, 40, 16)
    tq, tk, tv, tg, tb = (torch.from_numpy(a) for a in (q, k, v, g, bias))
    out, lse = ta.dropattn_fwd_plain(tq, tk, tv, tb, p, 21)
    mine = ta.dropattn_bwd_plain(tq, tk, tv, tb, p, 21, lse, tg)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = ta.dropout_attention_plain(*leaves, tb, p, 21)
    want = torch.autograd.grad(ref, leaves, tg)
    torch.testing.assert_close(out, ref.detach(), rtol=0, atol=1e-6)
    for a, b in zip(mine, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_same_seed_same_dropout_other_seed_other_dropout():
    q, k, v, _, bias = (torch.from_numpy(a) for a in _inputs(2, 2, 2, 32, 16))
    a = ta.dropout_attention(q, k, v, bias, 0.1, 8)
    assert torch.equal(a, ta.dropout_attention(q, k, v, bias, 0.1, 8))
    assert not torch.equal(a, ta.dropout_attention(q, k, v, bias, 0.1, 9))
    assert not torch.equal(a, ta.dropout_attention(q, k, v, bias, 0.0, 8))


def test_error_bounds_admit_rounding_and_catch_a_scale_fault():
    """The bf16 bounds the card's kernels are held to: the plain result
    against one computed without rounding pd and ds lies inside them; a 2%
    scale fault does not."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(4, 2, 3, 64, 32))
    qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q, k, v, g))
    want, lse = ta.dropattn_fwd_plain(qb, kb, vb, bias, 0.1, 5)
    unrounded, lse32 = ta.dropattn_fwd_plain(qb.float(), kb.float(), vb.float(), bias, 0.1, 5)
    got = unrounded.to(torch.bfloat16)
    ok = ta.dropattn_fwd_error_bound(qb, kb, vb, bias, 0.1, 5, got, want)
    assert bool(((got.float() - want.float()).abs() <= ok).all())
    faulty = (unrounded * 1.02).to(torch.bfloat16)
    bad = ta.dropattn_fwd_error_bound(qb, kb, vb, bias, 0.1, 5, faulty, want)
    assert not bool(((faulty.float() - want.float()).abs() <= bad).all())

    want_g = ta.dropattn_bwd_plain(qb, kb, vb, bias, 0.1, 5, lse, gb)
    exact = ta.dropattn_bwd_plain(qb.float(), kb.float(), vb.float(), bias, 0.1, 5, lse32,
                                  gb.float())
    got_g = [t.to(torch.bfloat16) for t in exact]
    bounds = ta.dropattn_bwd_error_bound(qb, kb, vb, bias, 0.1, 5, lse, gb, got_g, want_g)
    for a, b, bd in zip(got_g, want_g, bounds):
        assert bool(((a.float() - b.float()).abs() <= bd).all())
    faulty_g = [(t * 1.02).to(torch.bfloat16) for t in exact]
    bounds = ta.dropattn_bwd_error_bound(qb, kb, vb, bias, 0.1, 5, lse, gb, faulty_g, want_g)
    for a, b, bd in zip(faulty_g, want_g, bounds):
        assert not bool(((a.float() - b.float()).abs() <= bd).all())


def _held_to_the_bound(q, k, v, bias, p, seed, lse, g, got, want):
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, got, want)
    for name, a, b, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())
    faulty = [(t.float() * 1.02).to(t.dtype) for t in got]
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, faulty, want)
    for a, b, bd in zip(faulty, want, bounds):
        assert not bool(((a.float() - b.float()).abs() <= bd).all())


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("L", [48, 130])  # 130: a ragged last chunk of 16 keys
def test_tensor_core_backward_arithmetic_is_within_the_bound_of_the_jax_kernel(L, d):
    """The bf16 tensor-core backward's arithmetic (truncating mma sums, the
    exponent folded into one exp2; tests/torch_tc_emulation.py) against the
    JAX backward kernel in interpret mode at p = 0 on the same bf16 inputs,
    at head dims 16, 32 and 64: within dropattn_bwd_error_bound at every
    element; a 2% fault is not."""
    q, k, v, g, bias = _inputs(L + 1, 2, 3, L, d)
    qb, kb, vb, gb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    _, lse = ta.dropattn_fwd_plain(qb, kb, vb, tb, 0.0, 3)
    want = j_dropattn_bwd(0.0, True, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                       for t in (qb, kb, vb)),
                          jnp.asarray(bias), jnp.asarray([3], jnp.int32),
                          jnp.asarray(gb.float().numpy(), jnp.bfloat16))
    want = [torch.from_numpy(np.array(x.astype(jnp.bfloat16).astype(jnp.float32)))
            .to(torch.bfloat16) for x in want]
    got = dropattn_bwd_tc(qb, kb, vb, tb, 0.0, 3, lse, gb, None)
    _held_to_the_bound(qb, kb, vb, tb, 0.0, 3, lse, gb, got, want)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_tensor_core_backward_arithmetic_is_within_the_bound_of_the_plain_version(d):
    """At p = 0.1 (no JAX reference draws the port's mask) the same
    arithmetic against dropattn_bwd_plain, with the plain keep-mask."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(6, 2, 3, 64, d))
    qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q, k, v, g))
    _, lse = ta.dropattn_fwd_plain(qb, kb, vb, bias, 0.1, 17)
    keep = ta.dropout_keep_mask(17, 6, 64, 0.1).view(2, 3, 64, 64)
    got = dropattn_bwd_tc(qb, kb, vb, bias, 0.1, 17, lse, gb, keep)
    want = ta.dropattn_bwd_plain(qb, kb, vb, bias, 0.1, 17, lse, gb)
    _held_to_the_bound(qb, kb, vb, bias, 0.1, 17, lse, gb, got, want)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [64, 130, 192, 256])
def test_three_pass_backward_at_head_dim_16_is_the_buffer_kernels_arithmetic(L, p):
    """The bf16 backward at head dim 16 without its [L, L] buffer
    (tests/torch_tc_emulation.py ``dropattn_bwd_tc_3pass``: dv and dk from
    S^T = k q^T and dP^T = v g^T with the keys as rows) gives the buffer
    kernel's arithmetic (``dropattn_bwd_tc``) bit for bit, and is within
    dropattn_bwd_error_bound of dropattn_bwd_plain (with the plain keep-mask
    at p = 0.1) and, at p = 0, of the JAX backward kernel in interpret
    mode."""
    B, h, d = 2, 2, 16
    q, k, v, g, bias = _inputs(L + 16, B, h, L, d)
    qb, kb, vb, gb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    seed = 23 + L
    _, lse = ta.dropattn_fwd_plain(qb, kb, vb, tb, p, seed)
    keep = (ta.dropout_keep_mask(seed, B * h, L, p).view(B, h, L, L) if p > 0 else None)
    got = dropattn_bwd_tc_3pass(qb, kb, vb, tb, p, seed, lse, gb, keep)
    for a, b in zip(got, dropattn_bwd_tc(qb, kb, vb, tb, p, seed, lse, gb, keep)):
        assert torch.equal(a, b)
    refs = [ta.dropattn_bwd_plain(qb, kb, vb, tb, p, seed, lse, gb)]
    if p == 0:
        jax_want = j_dropattn_bwd(0.0, True, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                               for t in (qb, kb, vb)),
                                  jnp.asarray(bias), jnp.asarray([seed], jnp.int32),
                                  jnp.asarray(gb.float().numpy(), jnp.bfloat16))
        refs.append([torch.from_numpy(np.array(x.astype(jnp.bfloat16).astype(jnp.float32)))
                     .to(torch.bfloat16) for x in jax_want])
    for want in refs:
        bounds = ta.dropattn_bwd_error_bound(qb, kb, vb, tb, p, seed, lse, gb, got, want)
        for name, a, b, bd in zip(("dq", "dk", "dv"), got, want, bounds):
            diff = (a.float() - b.float()).abs()
            assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


def _f32_within_1e5(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_tf32_backward_arithmetic_is_within_1e5_of_the_plain_version(p):
    """The f32 route at head dim 64 (three TF32 products a product, their
    small terms in an accumulator of their own, truncating mma sums, dq's
    steps in the kernel's key order; tests/torch_tc_emulation.py
    dropattn_bwd_tf32) against dropattn_bwd_plain at [4, 16, 64, 64] with a
    padding bias, with the plain keep-mask at p = 0.1: within the 1e-5 the
    card holds the f32 kernel to."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(64, 4, 16, 64, 64))
    _, lse = ta.dropattn_fwd_plain(q, k, v, bias, p, 29)
    keep = None if p == 0 else ta.dropout_keep_mask(29, 64, 64, p).view(4, 16, 64, 64)
    got = dropattn_bwd_tf32(q, k, v, bias, p, lse, g, keep)
    _f32_within_1e5(got, ta.dropattn_bwd_plain(q, k, v, bias, p, 29, lse, g))


@pytest.mark.parametrize("L", [48, 100])  # 100: a ragged last chunk of 16 keys
def test_tf32_backward_arithmetic_is_within_1e5_of_the_jax_kernel(L):
    """The same against the JAX backward kernel in interpret mode at p = 0
    (f32): within 1e-5."""
    q, k, v, g, bias = _inputs(L + 5, 2, 3, L, 64)
    tq, tk, tv, tg, tb = (torch.from_numpy(a) for a in (q, k, v, g, bias))
    _, lse = ta.dropattn_fwd_plain(tq, tk, tv, tb, 0.0, 3)
    want = j_dropattn_bwd(0.0, True, *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias),
                          jnp.asarray([3], jnp.int32), jnp.asarray(g))
    got = dropattn_bwd_tf32(tq, tk, tv, tb, 0.0, lse, tg, None)
    _f32_within_1e5(got, [torch.from_numpy(np.array(x)) for x in want])


def test_one_pass_tf32_backward_fails_the_1e5_check():
    """One TF32 pass misses 1e-5 at the teacher's train shape by far: the
    f32 checks would catch a kernel that dropped the small terms."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(64, 4, 16, 64, 64))
    _, lse = ta.dropattn_fwd_plain(q, k, v, bias, 0.1, 29)
    keep = ta.dropout_keep_mask(29, 64, 64, 0.1).view(4, 16, 64, 64)
    got = dropattn_bwd_tf32(q, k, v, bias, 0.1, lse, g, keep, passes=1)
    want = ta.dropattn_bwd_plain(q, k, v, bias, 0.1, 29, lse, g)
    assert max((a - b).abs().max().item() for a, b in zip(got, want)) > 1e-4


def test_the_f32_backward_lanes_hold_whole_philox_groups():
    """The f32 tensor-core backward's index arithmetic (csrc/dropattn_bwd.cu
    key_slot and its fragment reads): lane (grp, tig) holds keys 4 tig ..
    4 tig + 3 of every 16-key chunk, the four words of one Philox call, and
    dq's steps read k rows 4 tig + 2 s and 4 tig + 2 s + 1, the keys of the
    ds values that lane gives as k = tig and tig + 4."""
    scores, dq_rows = tf32_fragment_keys()
    for lane in range(32):
        tig = lane & 3
        assert scores[lane] == [4 * tig + j for j in range(4)]
        assert dq_rows[lane] == [[4 * tig + 2 * s + b for b in range(2)] for s in range(2)]


def _tc_backward_smem(dtype, d: int, L: int) -> int:
    """Shared memory of one block of the tensor-core backward with one head
    buffer (csrc/dropattn_bwd.cu dt_smem_bytes)."""
    Lp = (L + 15) // 16 * 16
    if dtype == torch.bfloat16:
        head, elt = 4 * Lp * (d + 8) * 2 + 2 * Lp * 4, 2
    else:
        head, elt = Lp * (2 * (d + 8) + 2 * (d + 4)) * 4 + 2 * Lp * 4, 4
    return head + Lp * (Lp + 8) * elt + Lp * (Lp // 16) * 2 + 2 * Lp * 4


def test_tensor_core_backward_limits_are_the_longest_lengths_that_fit():
    """DROPATTN_TC_MAX_L is, for each (dtype, head dim), the longest L whose
    head fits the 232,448 bytes of shared memory a block may hold (the
    kernel refuses more), within its block size of 2 L threads."""
    for (dtype, d), limit in ta.DROPATTN_TC_MAX_L.items():
        threads = 512 if dtype == torch.bfloat16 else 256
        assert _tc_backward_smem(dtype, d, limit) <= 227 * 1024
        assert 2 * ((limit + 15) // 16 * 16) <= threads
        # one step longer breaks one of the two (at head dim 16 the threads)
        assert (_tc_backward_smem(dtype, d, limit + 16) > 227 * 1024
                or 2 * (limit + 16) > threads)
    assert set(ta.DROPATTN_TC_MAX_L) == {(torch.bfloat16, 16), (torch.bfloat16, 32),
                                         (torch.bfloat16, 64), (torch.float32, 64)}


def _fwd_within(q, k, v, bias, p, seed, got, want):
    bound = ta.dropattn_fwd_error_bound(q, k, v, bias, p, seed, got, want)
    return (got.float() - want.float()).abs() / bound


FWD_LENGTHS = [16, 64, 100, 192, 512]  # 100: a ragged last chunk of 16 keys
# head dims 32 and 64 at every length; 16 (the --tiny models) at the lengths
# its runs take and a ragged one
FWD_CASES = [(L, d) for d in (32, 64) for L in FWD_LENGTHS] + [(L, 16) for L in (64, 100, 192)]


@pytest.mark.parametrize("L,d", FWD_CASES)
def test_tensor_core_forward_arithmetic_is_within_the_bound_of_the_jax_kernel(L, d):
    """The bf16 tensor-core forward's arithmetic (truncating mma sums, two
    passes with the exponent folded into one exp2; tests/torch_tc_emulation.py)
    against the JAX forward kernel in interpret mode at p = 0 on the same
    bf16 inputs, at head dims 16, 32 and 64: within dropattn_fwd_error_bound at
    every element, its lse within 1e-4 of the plain one (the check the card
    holds the kernel to); the same arithmetic with every probability 2 % off
    is not."""
    q, k, v, _, bias = _inputs(L + 7, 2, 3, L, d)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tb = torch.from_numpy(bias)
    want = j_dropattn_fwd(0.0, True, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                       for t in (qb, kb, vb)),
                          jnp.asarray(bias), jnp.asarray([3], jnp.int32))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)
    got, lse = dropattn_fwd_tc(qb, kb, vb, tb, 0.0, None)
    ratio = _fwd_within(qb, kb, vb, tb, 0.0, 3, got, want)
    assert ratio.max().item() <= 1.0, ratio.max().item()
    _, want_lse = ta.dropattn_fwd_plain(qb, kb, vb, tb, 0.0, 3)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    faulty, _ = dropattn_fwd_tc(qb, kb, vb, tb, 0.0, None, fault=1.02)
    assert _fwd_within(qb, kb, vb, tb, 0.0, 3, faulty, want).max().item() > 1.0


@pytest.mark.parametrize("L,d", FWD_CASES)
def test_tensor_core_forward_arithmetic_is_within_the_bound_of_the_plain_version(L, d):
    """At p = 0.1 (no JAX reference draws the port's mask) the same
    arithmetic against dropattn_fwd_plain with the plain keep-mask, at head
    dims 16, 32 and 64; a 2 % fault in the probabilities, or the mask shifted by
    one key, is not."""
    q, k, v, _, bias = (torch.from_numpy(a) for a in _inputs(L + 11, 2, 3, L, d))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    keep = ta.dropout_keep_mask(19, 6, L, 0.1).view(2, 3, L, L)
    want, want_lse = ta.dropattn_fwd_plain(qb, kb, vb, bias, 0.1, 19)
    got, lse = dropattn_fwd_tc(qb, kb, vb, bias, 0.1, keep)
    ratio = _fwd_within(qb, kb, vb, bias, 0.1, 19, got, want)
    assert ratio.max().item() <= 1.0, ratio.max().item()
    assert (lse - want_lse).abs().max().item() <= 1e-4
    faulty, _ = dropattn_fwd_tc(qb, kb, vb, bias, 0.1, keep, fault=1.02)
    assert _fwd_within(qb, kb, vb, bias, 0.1, 19, faulty, want).max().item() > 1.0
    shifted, _ = dropattn_fwd_tc(qb, kb, vb, bias, 0.1, torch.roll(keep, 1, dims=-1))
    assert _fwd_within(qb, kb, vb, bias, 0.1, 19, shifted, want).max().item() > 1.0


def test_dropout_attention_checks_its_inputs():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError):
        ta.dropout_attention(q, q, q, torch.zeros(1, 5), 0.1, 0)
    with pytest.raises(ValueError):
        ta.dropout_attention(q, q, q, torch.zeros(1, 4), 1.0, 0)
    with pytest.raises(TypeError):
        ta.dropout_attention(q.half(), q.half(), q.half(), torch.zeros(1, 4), 0.1, 0)


# ---------------------------------------------------------------------------
# Head dim 64 (the teacher's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 3e-5, 0.0), ("bfloat16", 5e-2, 2e-2)])
@pytest.mark.parametrize("L", [16, 48])
def test_dropout_attention_p0_matches_jax_at_head_dim_64(dtype, atol, rtol, L):
    """As test_dropout_attention_p0_matches_jax at the teacher's head dim:
    the plain pair the wrappers run on the CPU against the JAX
    dropout_attention in interpret mode, forward and gradients, with the
    same tolerances (the sums over d are twice as deep, still far inside)."""
    q, k, v, g, bias = _inputs(L + 64, 2, 3, L, 64)
    want = _jax_fwd_grads(q, k, v, g, bias, getattr(jnp, dtype))
    got = _port_fwd_grads(q, k, v, g, bias, getattr(torch, dtype))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("L", [64, 256])
def test_the_mask_applied_at_head_dim_64_is_dropout_keep_mask(L):
    """q = k = 0 and a zero bias make each probability 1/L, each kept pd
    2/L at p = 0.5; v (and g) holding 2^(j % 8) in channel j // 8 make the
    f32 output (dv) spell each row's (column's) keep bits: at head dim 64
    the wrappers apply dropout_keep_mask, bit for bit (the check the card
    makes of the kernels)."""
    B, h, d, seed = 2, 3, 64, 123
    j = torch.arange(L)
    code = torch.zeros(L, d)
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d)
    bias = torch.zeros(B, L)
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    bit = torch.arange(8)

    def spell(x):
        n = (x[..., : L // 8] * (L / 2)).round().long()
        return ((n[..., None] >> bit) & 1).reshape(B, h, L, L).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5).view(B, h, L, L)
    assert bool((spell(out) == want).all())
    assert bool((spell(dv).transpose(-1, -2) == want).all())


def test_routes_send_head_dim_64_to_the_tensor_cores():
    """The routes at head dim 64: flash and both dropattn kernels take the
    tensor cores in bf16 and f32. The f32 forward streams the head and takes
    every L, at head dims 16 and 32 as at 64 (dropattn_fwd_tc_tf32_kernel);
    the bf16 forward takes L while the head's K and V fit a block (656 at
    d = 64, 1344 at d = 32) and the CUDA-core kernel past that; the backward
    holds the head in a block while it fits (208 in bf16, 128 in f32) and
    streams it on the tensor cores past that ("tc_stream"), as it does for
    f32 at head dim 32 at every L: no backward is left on the CUDA cores,
    and no f32 forward either. Flash takes the tensor cores at head dims
    16, 32 and 64 in f32 and in bf16."""
    limits, fwd_limits = ta.DROPATTN_TC_MAX_L, ta.DROPATTN_FWD_TC_MAX_L
    assert limits[(torch.bfloat16, 64)] == 208 and limits[(torch.float32, 64)] == 128
    assert fwd_limits == {(torch.bfloat16, 16): 2256, (torch.bfloat16, 32): 1344,
                          (torch.bfloat16, 64): 656}
    for L in (16, 64, 128, 129, 192, 208, 209, 256, 512, 656, 657, 1024, 1344, 1345, 2048):
        assert ta.dropattn_fwd_route(torch.float32, 64, L) == "tc"
        assert ta.dropattn_fwd_route(torch.bfloat16, 64, L) == (
            "tc" if L <= 656 else "cuda_core")
        for dtype in (torch.bfloat16, torch.float32):
            assert ta.dropattn_bwd_route(dtype, 64, L) == (
                "tc" if L <= limits[(dtype, 64)] else "tc_stream")
        assert ta.dropattn_fwd_route(torch.bfloat16, 32, L) == (
            "tc" if L <= 1344 else "cuda_core")
        assert ta.dropattn_fwd_route(torch.float32, 32, L) == "tc"
        assert ta.dropattn_bwd_route(torch.bfloat16, 32, L) == (
            "tc" if L <= limits[(torch.bfloat16, 32)] else "tc_stream")
        assert ta.dropattn_bwd_route(torch.float32, 32, L) == "tc_stream"
        # head dim 16 (the --tiny models): bf16 as at 32, f32 on the
        # tensor-core forward and the streaming backward
        assert ta.dropattn_fwd_route(torch.bfloat16, 16, L) == (
            "tc" if L <= 2256 else "cuda_core")
        assert ta.dropattn_fwd_route(torch.float32, 16, L) == "tc"
        assert ta.dropattn_bwd_route(torch.bfloat16, 16, L) == (
            "tc" if L <= limits[(torch.bfloat16, 16)] else "tc_stream")
        assert ta.dropattn_bwd_route(torch.float32, 16, L) == "tc_stream"
    assert ta.flash_route(torch.bfloat16, 64) == ta.flash_route(torch.float32, 64) == "tc"
    assert ta.flash_route(torch.bfloat16, 32) == "tc"
    assert ta.flash_route(torch.float32, 32) == ta.flash_route(torch.float32, 16) == "tc"
    assert ta.flash_route(torch.bfloat16, 16) == "tc"
    assert ta._DROPATTN_HEAD_DIMS == (16, 32, 64)


def test_error_bounds_at_head_dim_64_admit_rounding_and_catch_a_scale_fault():
    """The bf16 bounds the card holds the d = 64 kernels to: the plain
    result against one computed without rounding pd and ds lies inside
    them; a 2 % scale fault does not."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(8, 2, 3, 64, 64))
    qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q, k, v, g))
    want, lse = ta.dropattn_fwd_plain(qb, kb, vb, bias, 0.1, 5)
    unrounded, lse32 = ta.dropattn_fwd_plain(qb.float(), kb.float(), vb.float(), bias, 0.1, 5)
    got = unrounded.to(torch.bfloat16)
    ok = ta.dropattn_fwd_error_bound(qb, kb, vb, bias, 0.1, 5, got, want)
    assert bool(((got.float() - want.float()).abs() <= ok).all())
    faulty = (unrounded * 1.02).to(torch.bfloat16)
    bad = ta.dropattn_fwd_error_bound(qb, kb, vb, bias, 0.1, 5, faulty, want)
    assert not bool(((faulty.float() - want.float()).abs() <= bad).all())
    want_g = ta.dropattn_bwd_plain(qb, kb, vb, bias, 0.1, 5, lse, gb)
    exact = ta.dropattn_bwd_plain(qb.float(), kb.float(), vb.float(), bias, 0.1, 5, lse32,
                                  gb.float())
    _held_to_the_bound(qb, kb, vb, bias, 0.1, 5, lse, gb, [t.to(torch.bfloat16) for t in exact],
                       want_g)


# ---------------------------------------------------------------------------
# The f32 tensor-core forward at head dim 64 (one online pass, three TF32
# products a product) and the bf16 forward's limits
# ---------------------------------------------------------------------------


def _fwd_within_1e5(got, want):
    (out, lse), (want_out, want_lse) = got, want
    err = (out - want_out).abs().max().item()
    assert err <= 1e-5, err
    lse_err = (lse - want_lse).abs().max().item()
    assert lse_err <= 1e-4, lse_err


# (d, B, h, L): the teacher's train shape [4, 16, 64, 64] and eight tiles
# at head dim 64; the f32 student's train length 192 at 32 (ragged: three
# tiles, the last of them full) with its heads cut, and 100 (a ragged last
# tile); the tiny teacher's [*, 4, 64, 16]
F32_FWD_CASES = [(64, 4, 16, 64), (64, 2, 16, 512), (32, 2, 4, 192), (32, 2, 3, 100),
                 (16, 4, 4, 64)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("d,B,h,L", F32_FWD_CASES)
def test_tf32_forward_arithmetic_is_within_1e5_of_the_plain_version(d, B, h, L, p):
    """The f32 forwards (tests/torch_tc_emulation.py dropattn_fwd_tf32, which
    both f32 kernels compute: three TF32 products a product with their small
    terms apart, truncating mma sums, one online pass over 64-key tiles)
    against dropattn_fwd_plain at head dims 64, 32 and 16, with a padding
    bias and, at p = 0.1, the plain keep-mask: out within the 1e-5 and lse
    within the 1e-4 the card holds the kernels to."""
    q, k, v, _, bias = (torch.from_numpy(a) for a in _inputs(L + 3, B, h, L, d))
    keep = None if p == 0 else ta.dropout_keep_mask(31, B * h, L, p).view(B, h, L, L)
    got = dropattn_fwd_tf32(q, k, v, bias, p, keep)
    _fwd_within_1e5(got, ta.dropattn_fwd_plain(q, k, v, bias, p, 31))


@pytest.mark.parametrize("d", [64, 32, 16])
@pytest.mark.parametrize("L", [64, 128])
def test_tf32_forward_arithmetic_is_within_1e5_of_the_jax_kernel(L, d):
    """The same against the JAX forward kernel in interpret mode at p = 0
    (f32, a padding bias) at head dims 64, 32 and 16: out within 1e-5, lse
    within 1e-4 of the plain version's."""
    q, k, v, _, bias = _inputs(L + 9, 2, 3, L, d)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    want = j_dropattn_fwd(0.0, True, *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias),
                          jnp.asarray([3], jnp.int32))
    out, lse = dropattn_fwd_tf32(tq, tk, tv, tb, 0.0, None)
    err = np.abs(out.numpy() - np.asarray(want)).max()
    assert err <= 1e-5, err
    _, want_lse = ta.dropattn_fwd_plain(tq, tk, tv, tb, 0.0, 3)
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d,B,h,L", [(64, 4, 16, 64), (32, 2, 4, 192), (16, 4, 4, 64)])
def test_one_pass_tf32_forward_fails_the_1e5_check(d, B, h, L):
    """One TF32 pass misses 1e-5 by far at the teacher's train shape and at
    the student's and the tiny teacher's head dims: the f32 checks would
    catch a forward that dropped the small terms."""
    q, k, v, _, bias = (torch.from_numpy(a) for a in _inputs(67, B, h, L, d))
    keep = ta.dropout_keep_mask(31, B * h, L, 0.1).view(B, h, L, L)
    out, _ = dropattn_fwd_tf32(q, k, v, bias, 0.1, keep, passes=1)
    want, _ = ta.dropattn_fwd_plain(q, k, v, bias, 0.1, 31)
    assert (out - want).abs().max().item() > 1e-4


@pytest.mark.parametrize("d", [16, 32, 64])
def test_the_f32_forward_lanes_hold_whole_philox_groups(d):
    """The f32 tensor-core forward's index arithmetic at head dims 16, 32 and
    64 (K and V rows stored by csrc/attn_common.cuh slot_row, d + 4 floats
    apart): the key each score element's shared row holds is the key the
    kernel takes its bias and keep bit for; lane (grp, tig) holds keys
    4 tig .. 4 tig + 3 of every 16-key chunk of the tile, the four words of
    one Philox call; step nt of p v reads the V rows of the keys of that
    lane's score columns; and each score step ks < d / 8 reads K at columns
    8 ks + tig and + 4 of the key in shared row nt * 8 + grp, never a
    padding column."""
    stored, used, pv_rows, k_reads = tf32_forward_fragment_keys(d)
    key_at = {(r & ~15) + 8 * ((r >> 1) & 1) + 2 * ((r & 15) >> 2) + (r & 1): r for r in range(64)}
    for lane in range(32):
        grp, tig = lane >> 2, lane & 3
        assert stored[lane] == used[lane]
        for c in range(4):
            assert sorted(stored[lane][4 * c:4 * c + 4]) == [16 * c + 4 * tig + j for j in range(4)]
        assert pv_rows[lane] == stored[lane]
        assert k_reads[lane] == {(nt, ks, b): (key_at[nt * 8 + grp], 8 * ks + tig + 4 * b)
                                 for nt in range(8) for ks in range(d // 8) for b in range(2)}


def _tc_forward_smem(d: int, L: int) -> int:
    """Shared memory of one block of the bf16 tensor-core forward
    (csrc/dropattn_fwd.cu dft_smem_bytes): its q rows (16 a warp, dft_warps:
    128 at head dim 32; at 64, 64 while L <= 64 and 256 past that) and the
    head's k and v rows, padded to d + 8 bf16, and the bias."""
    Lp = (L + 15) // 16 * 16
    rows = 128 if d == 32 else 64 if L <= 64 else 128 if d == 16 else 256
    return (rows + 2 * Lp) * (d + 8) * 2 + Lp * 4


def test_tensor_core_forward_limits_are_the_longest_lengths_that_fit():
    """DROPATTN_FWD_TC_MAX_L is, for each head dim of the bf16 route, the
    longest L whose head fits the 232,448 bytes of shared memory a block
    may hold (the kernel refuses more); at head dim 64 it is past the
    longest length the teacher scores at (512)."""
    for (dtype, d), limit in ta.DROPATTN_FWD_TC_MAX_L.items():
        assert dtype == torch.bfloat16
        assert _tc_forward_smem(d, limit) <= 227 * 1024
        assert _tc_forward_smem(d, limit + 16) > 227 * 1024
    assert ta.DROPATTN_FWD_TC_MAX_L[(torch.bfloat16, 64)] >= 512
