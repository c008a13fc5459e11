"""Port vs JAX: attention.

The port's flash wrapper runs its plain version on the CPU; the JAX flash
kernel runs in interpret mode. f32 throughout; atol 1e-5 covers summation
order in two f32 matmuls and the softmax over at most 200 keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sskd_tpu.ops.attention import flash_attention as j_flash, xla_attention
from sskd_tpu_torch.ops import attention as ta
from torch_tc_emulation import flash_tc, flash_tf32, fragment_banks, ldmatrix_bank_groups


def _qkv(seed, B, h, L, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, L, d)).astype(np.float32) for _ in range(3)]


def _mask(seed, B, L):
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    return (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("L", [64, 200])  # 200: not a multiple of any tile
@pytest.mark.parametrize("masked", [False, True])
def test_flash_matches_jax(L, masked):
    q, k, v = _qkv(L, 3, 2, L, 16)
    mask = _mask(L, 3, L) if masked else None
    want = np.asarray(
        j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                mask=None if mask is None else jnp.asarray(mask), interpret=True)
    )
    got = ta.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("L", [16, 512])  # 512: the dispatcher takes the flash path
def test_plain_and_dispatch_match_xla_attention(L):
    q, k, v = _qkv(L + 7, 2, 2, L, 16)
    mask = _mask(L, 2, L)
    bias = ((1.0 - mask[:, None, None, :]) * (np.finfo(np.float32).min / 2)).astype(np.float32)
    want = np.asarray(xla_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias)))
    tq, tk_, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    np.testing.assert_allclose(ta.plain_attention(tq, tk_, tv, tb).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(ta.scaled_dot_attention(tq, tk_, tv, tb).numpy(), want, atol=1e-5)


def test_fully_masked_row_averages_values():
    """All keys masked: the reference averages v over its L keys."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 1, 8, 16))
    out = ta.flash_attention(q, k, v, torch.zeros(1, 8, dtype=torch.int32))
    torch.testing.assert_close(out[0, 0], v[0, 0].mean(dim=0).expand(8, 16), atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_error_bound_admits_rounding_and_catches_a_scale_fault(d):
    """The bf16 bound the card's kernel is held to, at the tiny models', the
    student's and the teacher's head dims: the plain result against one that skips the
    rounding of p lies inside it; a 2% scale fault does not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(5, 2, 3, 96, d))
    mask = torch.from_numpy(_mask(5, 2, 96))
    want = ta.flash_attention_plain(q, k, v, mask)
    unrounded_p = ta.flash_attention_plain(q.float(), k.float(), v.float(), mask)
    got = unrounded_p.to(torch.bfloat16)
    assert bool(((got.float() - want.float()).abs()
                 <= ta.flash_error_bound(q, k, v, mask, got, want)).all())
    faulty = (unrounded_p * 1.02).to(torch.bfloat16)
    assert not bool(((faulty.float() - want.float()).abs()
                     <= ta.flash_error_bound(q, k, v, mask, faulty, want)).all())


@pytest.mark.parametrize("d", [16, 32, 64])
def test_tensor_core_flash_arithmetic_is_within_the_bound_of_the_jax_kernel(d):
    """The bf16 tensor-core route's arithmetic (truncating mma sums, the scale
    folded into one exp2, 64-key online tiles; tests/torch_tc_emulation.py)
    against the JAX flash kernel in interpret mode on the same bf16 inputs,
    ragged L and a row with no live key included, at head dims 16, 32 and 64:
    within flash_error_bound at every element, and a 2% scale fault of it is
    not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(9, 3, 2, 200, d))
    mask = torch.from_numpy(_mask(9, 3, 200))
    mask[2] = 0
    want = np.array(j_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                              mask=jnp.asarray(mask.numpy()), interpret=True).astype(jnp.float32))
    want = torch.from_numpy(want).to(torch.bfloat16)
    got = flash_tc(q, k, v, mask)
    bound = ta.flash_error_bound(q, k, v, mask, got, want)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), (diff / bound).max().item()
    faulty = (got.float() * 1.02).to(torch.bfloat16)
    assert not bool(((faulty.float() - want.float()).abs()
                     <= ta.flash_error_bound(q, k, v, mask, faulty, want)).all())


@pytest.mark.parametrize("d", [16, 32, 64])
def test_tensor_core_flash_arithmetic_is_within_the_bound_of_the_plain_version(d):
    """The same bf16 arithmetic against flash_attention_plain (what the card
    holds the kernel to) at the teacher's scoring length, a half row and a
    row with no live key included: within flash_error_bound; a 2 % fault of
    it is not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(d + 3, 3, 4, 512, d))
    mask = torch.from_numpy(_mask(d + 3, 3, 512))
    mask[1] = (torch.arange(512) < 256).int()
    mask[2] = 0
    want = ta.flash_attention_plain(q, k, v, mask)
    got = flash_tc(q, k, v, mask)
    diff = (got.float() - want.float()).abs()
    bound = ta.flash_error_bound(q, k, v, mask, got, want)
    assert bool((diff <= bound).all()), (diff / bound).max().item()
    faulty = (got.float() * 1.02).to(torch.bfloat16)
    assert not bool(((faulty.float() - want.float()).abs()
                     <= ta.flash_error_bound(q, k, v, mask, faulty, want)).all())


def _f32_flash_case(seed, B, h, L, d=64):
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed, B, h, L, d))
    mask = torch.from_numpy(_mask(seed, B, L))
    return q, k, v, mask


# (d, B, h, L): the teacher's scoring width at head dim 64; the f32
# student's encode length at 32 and a cut of its heads; the tiny models'
# head dim 16 (any L: 256, four tiles)
F32_FLASH_CASES = [(64, 2, 16, 512), (32, 1, 4, 512), (16, 1, 4, 256)]


@pytest.mark.parametrize("d,B,h,L", F32_FLASH_CASES)
def test_tf32_flash_arithmetic_is_within_1e5_of_the_plain_version(d, B, h, L):
    """The f32 route (three TF32 products a product, their small terms in an
    accumulator of their own, truncating mma sums, the CUDA-core kernel's
    softmax; tests/torch_tc_emulation.py flash_tf32, which both f32 kernels
    compute) against flash_attention_plain at head dims 64, 32 and 16:
    within the 1e-5 the card holds the f32 kernels to."""
    q, k, v, mask = _f32_flash_case(21, B, h, L, d)
    err = (flash_tf32(q, k, v, mask) - ta.flash_attention_plain(q, k, v, mask)).abs().max()
    assert err.item() <= 1e-5, err.item()


@pytest.mark.parametrize("d", [64, 32, 16])
def test_tf32_flash_arithmetic_is_within_1e5_of_the_jax_kernel(d):
    """The same against the JAX flash kernel in interpret mode (f32), ragged
    L and a row with no live key included: within 1e-5."""
    q, k, v, mask = _f32_flash_case(23, 3, 2, 200, d)
    mask[2] = 0
    want = np.asarray(j_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              mask=jnp.asarray(mask.numpy()), interpret=True))
    err = np.abs(flash_tf32(q, k, v, mask).numpy() - want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("d,B,h,L", F32_FLASH_CASES)
def test_one_pass_tf32_flash_fails_the_1e5_check(d, B, h, L):
    """One TF32 pass (each operand rounded to TF32 once) misses 1e-5 at the
    same shapes by far: the f32 checks would catch a kernel that dropped
    the small terms."""
    q, k, v, mask = _f32_flash_case(21, B, h, L, d)
    err = (flash_tf32(q, k, v, mask, passes=1)
           - ta.flash_attention_plain(q, k, v, mask)).abs().max()
    assert err.item() > 1e-4, err.item()


@pytest.mark.parametrize("d", [16, 32, 64])
def test_f32_fragment_reads_hit_distinct_banks(d):
    """At the f32 kernels' row stride of d + 4 floats (20, 36, 68: 4 mod 16),
    each 4-byte fragment read of a warp (q's and K's at row grp, column tig;
    V's at row 2 tig, column grp) hits 32 distinct banks at head dims 16, 32
    and 64, as 68 does at 64: no read waits on another lane's."""
    for name, banks in fragment_banks(d).items():
        assert sorted(banks) == list(range(32)), name


@pytest.mark.parametrize("d", [16, 32, 64])
def test_bf16_ldmatrix_rows_fall_in_distinct_bank_groups(d):
    """At the bf16 kernels' row stride of d + 8 bf16 (24, 40, 72: 48, 80
    and 144 bytes, an odd number of 16-byte units), the eight row addresses
    of every 8 x 8 matrix an ldmatrix reads fall in eight distinct 16-byte
    bank groups: no row of a matrix waits on another's. At d = 16 that is
    the tensor-core flash's K (16-d fragments, two 8-key tiles an
    ldmatrix_x4), q and V (ldmatrix.trans) reads."""
    for (row0, col0), groups in ldmatrix_bank_groups(d).items():
        assert sorted(groups) == list(range(8)), (row0, col0, groups)
    assert ldmatrix_bank_groups(16)[(0, 0)] == [0, 3, 6, 1, 4, 7, 2, 5]


def test_flash_checks_shapes():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError):
        ta.flash_attention(q, q, q, torch.ones(1, 5))
    with pytest.raises(TypeError):
        ta.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("L", [64, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_matches_jax_at_head_dim_64(L, masked):
    """As test_flash_matches_jax at the teacher's head dim (on the CPU the
    wrapper runs the plain version; on the card d = 64 takes the tensor-core
    routes): atol 1e-5."""
    q, k, v = _qkv(L + 64, 3, 2, L, 64)
    mask = _mask(L + 64, 3, L) if masked else None
    want = np.asarray(
        j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                mask=None if mask is None else jnp.asarray(mask), interpret=True)
    )
    got = ta.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
