"""The CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card and nvcc are
there and skips with the reason otherwise. Run on a machine with the card:
``python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py``
(``tests/conftest.py`` imports JAX, which the GPU machine need not have).
"""

import os
import shutil

import pytest
import torch

from sskd_tpu_torch.ops import attention as ta
from sskd_tpu_torch.ops import topk_kernels as tk
from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("needs nvcc to build the kernels")


def _data(n, d, b, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, device="cuda", generator=g)
    q = torch.randn(b, d, device="cuda", generator=g)
    return x / x.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)


def _storage(dtype, x):
    if dtype == "f32":
        return x.contiguous(), None
    if dtype == "bf16":
        return x.to(torch.bfloat16).contiguous(), None
    return (quantize_rows if dtype == "int8" else quantize_rows_int4)(x)


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 5, 40])
def test_binmax_and_gather_match_plain(dtype, B):
    _need_card()
    x, q = _data(70_001, 384, B, seed=B)
    corpus, scales = _storage(dtype, x)
    q_in, q_scale = tk.quantize_queries(q, corpus)
    valid_n = 70_001 - 9
    got = tk.binmax(q_in, corpus, scales, valid_n)
    want = tk.binmax_plain(q_in, corpus, scales, valid_n)
    torch.cuda.synchronize()
    # int dots are exact; f32 dots differ by summation order only
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    _, bins = tk.topk_stable(want.T, 12)
    bins = bins.to(torch.int32).contiguous()
    got = tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
    want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_kernel_engine_matches_blocked_engine(dtype):
    from sskd_tpu_torch.ops.topk import cosine_topk_core

    _need_card()
    x, q = _data(100_000, 384, 16, seed=3)
    corpus, scales = _storage(dtype, x)
    kv, ki = tk.cosine_topk_kernels(q, corpus, 100, row_scales=scales, valid_n=99_990)
    bv, bi = cosine_topk_core(q, corpus, 100, row_scales=scales, valid_n=99_990)
    torch.testing.assert_close(kv, bv, rtol=1e-6, atol=1e-7)
    assert (ki == bi).float().mean().item() > 0.999  # ties aside


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,d", [(512, 32), (200, 16), (130, 64)])
def test_flash_matches_plain(dtype, L, d):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(L)
    q, k, v = (torch.randn(4, 3, L, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([L, L // 2, 1, 0], device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).to(torch.int32)
    got = ta.flash_attention(q, k, v, mask)
    want = ta.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        # per element, the bf16 rounding of p and of the output on each side
        bound = ta.flash_error_bound(q, k, v, mask, got, want)
        assert bool((diff <= bound).all()), (diff / bound).max().item()
    else:  # summation order only
        assert diff.max().item() <= 2e-6


@pytest.mark.parametrize("B", [4, 1])
@pytest.mark.parametrize("L", [64, 200, 512, 520])  # 200, 520: a ragged last tile
def test_flash_bf16_head_dim_16_tensor_core_route(L, B):
    """bf16 flash at head dim 16 (the tiny models' encode) on its
    tensor-core route: one launch counted on the route and at d = 16, rows
    whole, half, one key and no live key (B = 4) or one whole row (B = 1),
    within flash_error_bound of the plain version, the same bits over two
    launches."""
    _need_card()
    assert ta.flash_route(torch.bfloat16, 16) == "tc"
    g = torch.Generator(device="cuda").manual_seed(L + B)
    q, k, v = (torch.randn(B, 4, L, 16, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([L, L // 2, 1, 0][:B], device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).to(torch.int32)
    before = (ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches.get(16, 0))
    got = ta.flash_attention(q, k, v, mask)
    assert (ta.flash_attention.tc_launches,
            ta.flash_attention.head_dim_launches[16]) == (before[0] + 1, before[1] + 1)
    want = ta.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    bound = ta.flash_error_bound(q, k, v, mask, got, want)
    assert bool((diff <= bound).all()), (diff / bound).max().item()
    assert torch.equal(got, ta.flash_attention(q, k, v, mask))


def test_launch_counters_count_kernel_launches_only():
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts

    _need_card()
    reset_launch_counts()
    x, q = _data(1000, 64, 2, seed=0)
    tk.binmax(q, x)
    tk.binmax_plain(q, x)
    assert launch_counts()["binmax"] == 1


# ---------------------------------------------------------------------------
# Training attention: the dropattn kernels and the flash backward
# ---------------------------------------------------------------------------


def _attn_inputs(B, h, L, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, go = (torch.randn(B, h, L, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    lens = torch.randint(1, L + 1, (B,), device="cuda", generator=g)
    lens[0] = L
    keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min / 2)
    return q, k, v, go, bias


@pytest.mark.parametrize("L", [64, 192, 512, 130])
def test_dropattn_keep_mask_matches_plain(L):
    _need_card()
    BH = 3072 if L == 64 else 24
    got = ta.dropattn_keep_mask_kernel(1234567, BH, L, 0.1)
    want = ta.dropout_keep_mask(1234567, BH, L, 0.1, device="cuda")
    assert bool((got == want).all())


def test_dropattn_kernels_apply_the_plain_mask():
    """q = k = 0 and a zero bias make every probability 1/256 at L = 256; at
    p = 0.5 each kept one is 1/128 exactly, so with v (or g) holding 2^(j % 8)
    in channel j // 8, the f32 output (or dv) spells each row's (or column's)
    keep bits: the masks the kernels used, read back bit for bit."""
    _need_card()
    B, h, L, d, seed = 2, 3, 256, 32, 99
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda")
    bias = torch.zeros(B, L, device="cuda")
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    bit = torch.arange(8, device="cuda")

    def spell(x):  # [B, h, L, 32] sums of 2^bit / 128 -> [B, h, L, 256] bits
        n = (x * 128).round().long()
        return ((n[..., None] >> bit) & 1).reshape(B, h, L, L).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    assert bool((spell(out) == want).all())
    assert bool((spell(dv).transpose(-1, -2) == want).all())


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [64, 192, 130])
def test_dropattn_fwd_bwd_match_plain(dtype, p, L, d):
    _need_card()
    q, k, v, go, bias = _attn_inputs(3, 4, L, d, dtype, seed=L)
    seed = 77 + L
    out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
    grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    want_grads = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
    if dtype == torch.float32:  # summation order only
        assert (out - want).abs().max().item() <= 1e-5
        for a, b in zip(grads, want_grads):
            assert (a - b).abs().max().item() <= 1e-5
        return
    bound = ta.dropattn_fwd_error_bound(q, k, v, bias, p, seed, out, want)
    assert bool(((out.float() - want.float()).abs() <= bound).all())
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, grads, want_grads)
    for name, a, b, bd in zip("dq dk dv".split(), grads, want_grads, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


@pytest.mark.parametrize("d", [48, 128])
def test_dropattn_refuses_other_head_dims(d):
    """The kernels are built for d = 16, 32 and 64 only: any other head dim
    raises before a launch."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(2, 3, 64, d, torch.bfloat16, seed=d)
    before = ta.dropattn_fwd.launches
    with pytest.raises(ValueError, match="head dims"):
        ta.dropattn_fwd(q, k, v, bias, 0.1, 5)
    lse = torch.zeros(q.shape[:3], device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        ta.dropattn_bwd(q, k, v, bias, 0.1, 5, lse, go)
    assert ta.dropattn_fwd.launches == before


def test_dropout_attention_gradient_goes_through_the_kernels():
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts

    _need_card()
    q, k, v, go, bias = _attn_inputs(2, 3, 96, 32, torch.float32, seed=5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    out = ta.dropout_attention(*leaves, bias, 0.1, 42)
    got = torch.autograd.grad(out, leaves, go)
    counts = launch_counts()
    assert counts["dropattn_fwd"] == 1 and counts["dropattn_bwd"] == 1
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = ta.dropout_attention_plain(*ref_leaves, bias, 0.1, 42)
    want = torch.autograd.grad(ref, ref_leaves, go)
    assert (out - ref).abs().max().item() <= 1e-5
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_matches_plain_autograd(dtype):
    """scaled_dot_attention at L = 512 runs the flash kernel forward and the
    plain VJP backward: its gradients equal autograd through plain_attention
    on the same bias (the same arithmetic, so to f32 summation order)."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(2, 3, 512, 32, dtype, seed=11)
    bias4 = bias.to(dtype)[:, None, None, :]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ta.flash_attention.launches
    out = ta.scaled_dot_attention(*leaves, bias4)
    assert ta.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, go)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ta.plain_attention(*ref_leaves, bias4), ref_leaves, go)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The approx engine's strided pass and the cell-gather kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
@pytest.mark.parametrize("B,blocks", [(1, 7), (3, 100), (16, 528), (40, 547)])
def test_binmax_strided_matches_plain(dtype, B, blocks):
    _need_card()
    x, q = _data(70_001, 384, B, seed=100 + B)
    if 4999 + 128 * blocks < x.shape[0]:
        x[4999 + 128 * blocks] = x[4999]  # equal rows in one bin: the lower wins the tie
    corpus, scales = _storage(dtype, x)
    q_in, _ = tk.quantize_queries(q, corpus)
    valid_n = 70_001 - 200  # the last tile holds no valid row, the one before some
    before = tk.binmax_strided.launches
    got, rows = tk.binmax_strided(q_in, corpus, scales, valid_n, blocks)
    want, want_rows = tk.binmax_strided_plain(q_in, corpus, scales, valid_n, blocks)
    torch.cuda.synchronize()
    assert tk.binmax_strided.launches == before + 1
    assert rows.dtype == torch.int32 and rows.shape == got.shape == (blocks * 128, B)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if dtype == "f32":  # summation order can move a near-tie: the row must hold the maximum
        live = got > tk.NEG_INF / 2
        picked = x[rows.long().clamp(max=valid_n - 1)]  # [bins, B, D]
        score = torch.einsum("gbd,bd->gb", picked, q)
        torch.testing.assert_close(score[live], got[live], rtol=1e-5, atol=1e-6)
        assert (rows == want_rows).float().mean().item() > 0.999
    else:
        assert torch.equal(got, want) and torch.equal(rows, want_rows)


def _cells(dtype, n_cells, rpc, d, B, nprobe, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n_cells * rpc, d, device="cuda", generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn(B, d, device="cuda", generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    corpus, scales = _storage(dtype, x)
    probe = torch.stack([torch.randperm(n_cells, device="cuda", generator=g)[:nprobe]
                         for _ in range(B)]).to(torch.int32).contiguous()
    return q, corpus, scales, probe


@pytest.mark.parametrize("dtype", ["int8", "f32"])
@pytest.mark.parametrize("B,nprobe,rpc,d", [(1, 11, 768, 384), (1, 64, 1024, 384), (3, 11, 768, 384),
                                            (16, 8, 1024, 384), (5, 3, 200, 48), (1, 3, 200, 48),
                                            (2, 5, 256, 1040)])
def test_cell_gather_matches_plain(dtype, B, nprobe, rpc, d):
    from sskd_tpu_torch.ops import topk_cluster as tc

    _need_card()
    q, corpus, scales, probe = _cells(dtype, 70, rpc, d, B, nprobe, seed=B * 100 + nprobe)
    q_in, q_scale = tk.quantize_queries(q, corpus)
    wrapper, plain = ((tc.cell_gather_b1, tc.cell_gather_b1_plain) if B == 1
                      else (tc.cell_gather, tc.cell_gather_plain))
    before = wrapper.launches
    got = wrapper(q_in, q_scale, corpus, scales, probe, rpc)
    want = plain(q_in, q_scale, corpus, scales, probe, rpc)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == (B, nprobe, rpc)
    if dtype == "int8":  # exact integer dots, the same two products in the same order
        assert torch.equal(got, want)
    else:  # summation order only
        assert (got - want).abs().max().item() <= 1e-5
    if B > 1:  # the general kernel also takes one query
        one = tc.cell_gather(q_in[:1], None if q_scale is None else q_scale[:1], corpus, scales,
                             probe[:1], rpc)
        assert torch.equal(one, got[:1])


def test_cell_gather_refuses_what_the_kernels_do_not_take():
    from sskd_tpu_torch.ops import topk_cluster as tc

    _need_card()
    q, corpus, scales, probe = _cells("int8", 8, 256, 384, 2, 3, seed=1)
    q_in, q_scale = tk.quantize_queries(q, corpus)
    before = tc.cell_gather.launches
    bad = probe.clone()
    bad[1, 2] = 8
    with pytest.raises(ValueError, match="outside"):
        tc.cell_gather(q_in, q_scale, corpus, scales, bad, 256)
    with pytest.raises(ValueError, match="contiguous"):
        tc.cell_gather(q_in, q_scale, corpus, scales, probe.T.contiguous().T, 256)
    with pytest.raises(ValueError, match="16 bytes"):
        tc.cell_gather(q_in[:, :40].contiguous(), q_scale, corpus[:, :40].contiguous(), scales,
                       probe, 256)
    with pytest.raises(ValueError, match="expected"):
        tc.cell_gather(q_in, q_scale, corpus, scales.cpu(), probe, 256)
    assert tc.cell_gather.launches == before


@pytest.mark.parametrize("dtype", ["int8", "f32"])
def test_clustered_and_approx_engines_match_their_plain_versions(dtype):
    from sskd_tpu_torch.ops import topk_cluster as tc
    from sskd_tpu_torch.ops.topk import approx_topk, cosine_topk

    _need_card()
    n_cells, rpc, n = 100, 1024, 100 * 1024 - 300
    q, corpus, scales, _ = _cells(dtype, n_cells, rpc, 384, 16, 1, seed=7)
    cent = corpus.view(n_cells, rpc, -1).float().mean(dim=1)
    cent = cent / cent.norm(dim=1, keepdim=True)
    for B in (1, 16):
        got = tc.clustered_topk(q[:B], corpus, cent, 10, 16, rpc, row_scales=scales, valid_n=n)
        want = tc.clustered_topk(q[:B], corpus, cent, 10, 16, rpc, row_scales=scales, valid_n=n,
                                 kernels=False)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        assert (got[1] == want[1]).float().mean().item() > 0.99 and (got[1] < n).all()
    kv, ki = cosine_topk(q, corpus, 10, row_scales=scales, valid_n=n, method="approx")
    pv, pi = approx_topk(q, corpus, 10, row_scales=scales, valid_n=n, kernels=False)
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-6)
    assert (ki == pi).float().mean().item() > 0.99


# ---------------------------------------------------------------------------
# The tensor-core routes of flash_attn_fwd and dropattn_bwd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [512, 200, 130])
def test_flash_tensor_core_route_matches_plain(L):
    """bf16 at head dim 32 takes the tensor-core kernel: ragged L, a half
    row, one live key and no live key, each element within its bound."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1000 + L)
    q, k, v = (torch.randn(4, 12, L, 32, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([L, L // 2, 1, 0], device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).to(torch.int32)
    before, tc_before = ta.flash_attention.launches, ta.flash_attention.tc_launches
    got = ta.flash_attention(q, k, v, mask)
    want = ta.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert ta.flash_route(q.dtype, 32) == "tc"
    assert ta.flash_attention.launches == before + 1
    assert ta.flash_attention.tc_launches == tc_before + 1
    diff = (got.float() - want.float()).abs()
    bound = ta.flash_error_bound(q, k, v, mask, got, want)
    assert bool((diff <= bound).all()), (diff / bound).max().item()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [64, 192, 130])
def test_dropattn_bwd_tensor_core_route_matches_plain(p, L):
    _need_card()
    q, k, v, go, bias = _attn_inputs(4, 12, L, 32, torch.bfloat16, seed=300 + L)
    seed = 5 + L
    _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    tc_before = ta.dropattn_bwd.tc_launches
    grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
    torch.cuda.synchronize()
    assert ta.dropattn_bwd.tc_launches == tc_before + 1
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, grads, want)
    for name, a, b, bd in zip("dq dk dv".split(), grads, want, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


def test_dropattn_bwd_tensor_core_route_is_bitwise_repeatable():
    """No atomics and no order that varies between launches."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(8, 12, 192, 32, torch.bfloat16, seed=9)
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 21)
    first = ta.dropattn_bwd(q, k, v, bias, 0.1, 21, lse, go)
    second = ta.dropattn_bwd(q, k, v, bias, 0.1, 21, lse, go)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_routes_and_their_counters():
    """Each call counts one launch; only the tensor-core routes count in
    tc_launches: flash at every (dtype, head dim), the forward for bf16 at
    L <= 1344 and f32 at every L, the backward at every L (bf16 at L <= 256
    holding the head, f32 and longer L streaming it, counted in
    stream_launches too); the bf16 forward past its limit takes the
    CUDA-core kernel."""
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts, tc_launch_counts

    _need_card()
    reset_launch_counts()
    for dtype, d in ((torch.bfloat16, 32), (torch.float32, 32), (torch.bfloat16, 16)):
        q = torch.randn(2, 3, 96, d, device="cuda").to(dtype)
        ta.flash_attention(q, q, q)
    for dtype, L in ((torch.bfloat16, 192), (torch.float32, 192), (torch.bfloat16, 320),
                     (torch.bfloat16, 1360)):
        q, k, v, go, bias = _attn_inputs(2, 3, L, 32, dtype, seed=L)
        _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 3)
        if L <= 320:
            ta.dropattn_bwd(q, k, v, bias, 0.1, 3, lse, go)
    torch.cuda.synchronize()
    counts, tc = launch_counts(), tc_launch_counts()
    assert counts["flash_attn_fwd"] == 3 and tc["flash_attn_fwd"] == 3
    assert counts["dropattn_bwd"] == 3 and tc["dropattn_bwd"] == 3
    assert ta.dropattn_bwd.stream_launches == 2  # f32 at 192, bf16 at 320
    assert counts["dropattn_fwd"] == 4 and tc["dropattn_fwd"] == 3
    limit = ta.DROPATTN_TC_MAX_L[(torch.bfloat16, 32)]
    assert ta.dropattn_bwd_route(torch.bfloat16, 32, limit) == "tc"
    assert ta.dropattn_bwd_route(torch.bfloat16, 32, limit + 1) == "tc_stream"
    assert ta.dropattn_bwd_route(torch.float32, 32, 64) == "tc_stream"
    fwd_limit = ta.DROPATTN_FWD_TC_MAX_L[(torch.bfloat16, 32)]
    assert ta.dropattn_fwd_route(torch.bfloat16, 32, fwd_limit) == "tc"
    assert ta.dropattn_fwd_route(torch.bfloat16, 32, fwd_limit + 1) == "cuda_core"
    assert ta.dropattn_fwd_route(torch.float32, 32, 64) == "tc"
    reset_launch_counts()
    assert tc_launch_counts() == {"flash_attn_fwd": 0, "dropattn_fwd": 0, "dropattn_bwd": 0,
                                  "cell_gather": 0, "bin_gather": 0, "binmax_strided": 0,
                                  "binmax": 0}
    assert ta.dropattn_bwd.stream_launches == 0


@pytest.mark.parametrize("d", [16, 32, 64])
def test_dropattn_tensor_core_backward_applies_the_plain_mask(d):
    """bf16 at L = 192: a bias that leaves keys 0..127 live makes each live
    probability 1/128, so at p = 0.5 each kept pd is 1/64 exactly in bf16;
    with v (and g) holding 2^(j % 8) in channel j // 8, out spells each row's
    keep bits over the live columns and dv each live column's over the 192
    rows: the keep bits the tensor-core forward applied and the tensor-core
    backward stored and applied, at head dims 32 and 64; at head dim 16 (16
    channels spell 128 rows) L = 128, every key live."""
    _need_card()
    B, h, L, live, seed = 2, 3, 192 if d > 16 else 128, 128, 99
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.to(torch.bfloat16).expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda", dtype=torch.bfloat16)
    bias = torch.where(j < live, 0.0, torch.finfo(torch.bfloat16).min / 2).expand(B, L)
    bias = bias.contiguous()
    fwd_before = ta.dropattn_fwd.tc_launches
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    assert ta.dropattn_fwd.tc_launches == fwd_before + 1
    tc_before = ta.dropattn_bwd.tc_launches
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    assert ta.dropattn_bwd.tc_launches == tc_before + 1
    bit = torch.arange(8, device="cuda")

    def spell(x, n):  # [..., 32] sums of 2^bit / 64 -> [..., n] bits
        c = (x.float() * 64).round().long()[..., : n // 8]
        return ((c[..., None] >> bit) & 1).flatten(-2).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    assert bool((spell(out, live) == want[..., :live]).all())
    assert bool((spell(dv[:, :, :live], L) == want[..., :live].transpose(-1, -2)).all())


# ---------------------------------------------------------------------------
# The tensor-core dropattn_fwd and the tensor-core cell_gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [16, 64, 100, 130, 192, 256, 512])
def test_dropattn_fwd_tensor_core_route_matches_plain(p, L):
    """bf16 at head dim 32 takes the tensor-core forward at every L the
    trainer uses and beyond: each element within dropattn_fwd_error_bound,
    the lse within 1e-4 of the plain one (what the backward reads)."""
    _need_card()
    q, k, v, _, bias = _attn_inputs(4, 12, L, 32, torch.bfloat16, seed=500 + L)
    seed = 40 + L
    before, tc_before = ta.dropattn_fwd.launches, ta.dropattn_fwd.tc_launches
    out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
    torch.cuda.synchronize()
    assert ta.dropattn_fwd_route(q.dtype, 32, L) == "tc"
    assert ta.dropattn_fwd.launches == before + 1
    assert ta.dropattn_fwd.tc_launches == tc_before + 1
    assert (lse - want_lse).abs().max().item() <= 1e-4
    diff = (out.float() - want.float()).abs()
    bound = ta.dropattn_fwd_error_bound(q, k, v, bias, p, seed, out, want)
    assert bool((diff <= bound).all()), (diff / bound).max().item()


def test_dropattn_fwd_tensor_core_route_is_bitwise_repeatable():
    _need_card()
    q, k, v, _, bias = _attn_inputs(8, 12, 192, 32, torch.bfloat16, seed=13)
    first = ta.dropattn_fwd(q, k, v, bias, 0.1, 21)
    second = ta.dropattn_fwd(q, k, v, bias, 0.1, 21)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("L", [64, 256, 512])
def test_dropattn_fwd_tensor_core_route_applies_the_plain_mask(L):
    """bf16, q = k = 0 and a zero bias: each probability is 1/L, each kept
    pd 2/L at p = 0.5, exact in bf16. With v holding 2^(j % 8) in channel
    (j // 8) % 32 for the keys j of one window of 256 (0 elsewhere), out
    spells each row's keep bits over that window: the mask the tensor-core
    forward applied, read back bit for bit over every column."""
    _need_card()
    B, h, d, seed = 2, 3, 32, 71
    zero = torch.zeros(B, h, L, d, device="cuda", dtype=torch.bfloat16)
    bias = torch.zeros(B, L, device="cuda")
    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    j = torch.arange(L, device="cuda")
    bit = torch.arange(8, device="cuda")
    tc_before = ta.dropattn_fwd.tc_launches
    for w0 in range(0, L, 256):
        n = min(256, L - w0)
        code = torch.zeros(L, d, device="cuda")
        win = j[w0:w0 + n]
        code[win, (win - w0) // 8] = (2.0 ** (win % 8)).float()
        code = code.to(torch.bfloat16).expand(B, h, L, d).contiguous()
        out, _ = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
        c = (out.float() * (L / 2)).round().long()[..., : n // 8]
        spelled = ((c[..., None] >> bit) & 1).flatten(-2).bool()
        assert bool((spelled == want[..., w0:w0 + n]).all())
    assert ta.dropattn_fwd.tc_launches == tc_before + (L + 255) // 256


@pytest.mark.parametrize("B,nprobe,rpc,same", [
    (2, 64, 1024, False), (16, 64, 1024, False), (64, 64, 1024, False), (200, 11, 768, False),
    (64, 11, 768, True), (200, 64, 1024, True), (3, 11, 768, False), (16, 5, 200, False),
])
def test_cell_gather_tensor_core_route_is_bit_for_bit(B, nprobe, rpc, same):
    """int8 at any batch takes the tensor-core route: bit for bit with the
    plain version where queries share cells (runs of the sorted pairs
    straddle a cell at every batch above one run), where every query probes
    the same cells (one block scores them all), on ragged cells (768, 200
    rows: partial 64-row tiles) and at nprobe 11."""
    from sskd_tpu_torch.ops import topk_cluster as tc

    _need_card()
    n_cells = 70 if rpc <= 768 else 977
    q, corpus, scales, probe = _cells("int8", n_cells, rpc, 384, B, nprobe, seed=B + nprobe)
    if same:
        probe = probe[:1].expand(B, nprobe).contiguous()
    q_in, q_scale = tk.quantize_queries(q, corpus)
    assert tc.cell_gather_route(corpus.dtype, 384) == "tc"
    before, tc_before = tc.cell_gather.launches, tc.cell_gather.tc_launches
    got = tc.cell_gather(q_in, q_scale, corpus, scales, probe, rpc)
    want = tc.cell_gather_plain(q_in, q_scale, corpus, scales, probe, rpc)
    again = tc.cell_gather(q_in, q_scale, corpus, scales, probe, rpc)
    torch.cuda.synchronize()
    assert tc.cell_gather.launches == before + 2 and tc.cell_gather.tc_launches == tc_before + 2
    assert torch.equal(got, want) and torch.equal(again, want)


def test_cell_gather_routes_by_dtype_and_row_size():
    from sskd_tpu_torch.ops import topk_cluster as tc

    _need_card()
    assert tc.cell_gather_route(torch.int8, tc.CELL_TC_MAX_ROW_BYTES) == "tc"
    assert tc.cell_gather_route(torch.int8, tc.CELL_TC_MAX_ROW_BYTES + 16) == "cuda_core"
    assert tc.cell_gather_route(torch.float32, 384 * 4) == "cuda_core"
    for dtype, d in (("int8", 1040), ("f32", 384)):
        q, corpus, scales, probe = _cells(dtype, 20, 256, d, 4, 5, seed=d)
        q_in, q_scale = tk.quantize_queries(q, corpus)
        tc_before = tc.cell_gather.tc_launches
        got = tc.cell_gather(q_in, q_scale, corpus, scales, probe, 256)
        want = tc.cell_gather_plain(q_in, q_scale, corpus, scales, probe, 256)
        torch.cuda.synchronize()
        assert tc.cell_gather.tc_launches == tc_before
        assert (got - want).abs().max().item() <= (0.0 if dtype == "int8" else 1e-5)


# ---------------------------------------------------------------------------
# The tensor-core routes of binmax_strided and bin_gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,blocks,d", [(1, 7, 384), (5, 100, 384), (16, 528, 384),
                                        (40, 547, 384), (64, 525, 384), (256, 133, 384),
                                        (16, 100, 1024), (65, 259, 1024), (3, 11, 48)])
def test_binmax_strided_tensor_core_route_is_bit_for_bit(B, blocks, d):
    """int8 takes the tensor-core route: maxima and rows bit for bit with
    the plain version, ties to the lower row, a last tile of no valid row,
    rows of 48 bytes (a zero tail) to 1,024, and bitwise equal over two
    launches."""
    _need_card()
    x, q = _data(70_001, d, B, seed=200 + B)
    if 4999 + 128 * blocks < x.shape[0]:
        x[4999 + 128 * blocks] = x[4999]
    q[0] = x[4999]
    corpus, scales = _storage("int8", x)
    q_in, _ = tk.quantize_queries(q, corpus)
    valid_n = 70_001 - 200
    assert tk.binmax_strided_route(corpus.dtype, d) == "tc"
    before, tc_before = tk.binmax_strided.launches, tk.binmax_strided.tc_launches
    got, rows = tk.binmax_strided(q_in, corpus, scales, valid_n, blocks)
    again, again_rows = tk.binmax_strided(q_in, corpus, scales, valid_n, blocks)
    want, want_rows = tk.binmax_strided_plain(q_in, corpus, scales, valid_n, blocks)
    torch.cuda.synchronize()
    assert tk.binmax_strided.launches == before + 2
    assert tk.binmax_strided.tc_launches == tc_before + 2
    assert torch.equal(got, want) and torch.equal(rows, want_rows)
    assert torch.equal(again, got) and torch.equal(again_rows, rows)
    if 4999 + 128 * blocks < x.shape[0]:
        assert int(rows[4999 % (128 * blocks), 0]) == 4999


@pytest.mark.parametrize("B,kb,d", [(1, 10, 384), (5, 10, 384), (16, 10, 384), (40, 10, 384),
                                    (64, 10, 384), (256, 10, 384), (16, 100, 384),
                                    (64, 100, 384), (16, 10, 1024), (5, 12, 48)])
def test_bin_gather_tensor_core_route_is_bit_for_bit(B, kb, d):
    """int8 takes the tensor-core route: scores bit for bit with the plain
    version, also where queries share bins and for the ragged last bin, at
    rows of 48 to 1,024 bytes, and bitwise equal over two launches."""
    _need_card()
    n = 70_001
    x, q = _data(n, d, B, seed=300 + B + kb)
    corpus, scales = _storage("int8", x)
    q_in, q_scale = tk.quantize_queries(q, corpus)
    n_bins = (n + 127) // 128
    g = torch.Generator(device="cuda").manual_seed(B * kb)
    bins = torch.stack([torch.randperm(n_bins, device="cuda", generator=g)[:kb]
                        for _ in range(B)]).to(torch.int32)
    bins[: max(1, B // 2), 0] = n_bins - 1  # the ragged last bin, shared
    bins[B // 2:, 1:] = bins[0, 1:].clone()  # the other half share the rest with query 0
    bins = bins.contiguous()
    valid_n = n - 40
    assert tk.bin_gather_route(corpus.dtype, d) == "tc"
    before, tc_before = tk.bin_gather.launches, tk.bin_gather.tc_launches
    got = tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
    again = tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
    want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n)
    torch.cuda.synchronize()
    assert tk.bin_gather.launches == before + 2 and tk.bin_gather.tc_launches == tc_before + 2
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("d", [32, 96, 384, 1024])
@pytest.mark.parametrize("kb", [1, 10, 100])
@pytest.mark.parametrize("B", [1, 7, 16, 65, 256])
def test_int4_bin_gather_tensor_core_route_is_bit_for_bit(B, kb, d):
    """Packed int4 rows of 16 to 512 bytes take bin_gather's tensor-core
    kernel (counted in tc_launches): scores bit for bit with the plain
    version, where queries share bins, for the ragged last bin and a valid_n
    that cuts the bin before it, at a half of 16 mod 32 bytes (D = 96: each
    half's query lanes past its bytes must read as zeros), and bitwise
    equal over two launches."""
    _need_card()
    n = 70_001  # 547 bins, the last of 113 rows
    x, q = _data(n, d, B, seed=800 + B + kb + d)
    corpus, scales = _storage("int4", x)
    q_in, q_scale = tk.quantize_queries(q, corpus)
    assert corpus.shape[1] == d // 2 and tk.bin_gather_route(corpus.dtype, d // 2) == "tc"
    g = torch.Generator(device="cuda").manual_seed(B * kb + d)
    bins = torch.stack([torch.randperm(547, device="cuda", generator=g)[:kb]
                        for _ in range(B)]).to(torch.int32)
    bins[: max(1, B // 2), 0] = 546  # the ragged last bin, shared
    if kb > 1:
        bins[B // 2:, 1] = 545  # the bin that valid_n cuts
        bins[B // 2:, 2:] = bins[0, 2:].clone()  # shared with query 0
    bins = bins.contiguous()
    valid_n = 545 * 128 + 70
    before = (tk.bin_gather.launches, tk.bin_gather.tc_launches, tk.bin_gather.bf16_launches)
    got = tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
    again = tk.bin_gather(q_in, q_scale, corpus, scales, bins, valid_n)
    want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins, valid_n)
    torch.cuda.synchronize()
    assert (tk.bin_gather.launches, tk.bin_gather.tc_launches,
            tk.bin_gather.bf16_launches) == (before[0] + 2, before[1] + 2, before[2])
    assert torch.equal(got, want) and torch.equal(again, got)
    rows = bins.long()[:, :, None] * 128 + torch.arange(128, device="cuda")
    assert torch.equal(got == tk.NEG_INF, rows >= valid_n)


@pytest.mark.parametrize("dtype,d", [("f32", 1028), ("int4", 1056), ("int8", 1040)])
def test_topk_cuda_core_routes_and_their_counters(dtype, d):
    """f32 rows past the f32 gather's 1,024 floats, and packed int4 (528
    bytes) and int8 rows over the limits, stay on the CUDA-core kernels of
    binmax, binmax_strided and bin_gather: counted in launches, not in
    tc_launches."""
    _need_card()
    x, q = _data(20_001, d, 4, seed=d)
    corpus, scales = _storage(dtype, x)
    q_in, q_scale = tk.quantize_queries(q, corpus)
    row_bytes = corpus.shape[1] * corpus.element_size()
    assert tk.binmax_route(corpus.dtype, row_bytes) == "cuda_core"
    assert tk.binmax_strided_route(corpus.dtype, row_bytes) == "cuda_core"
    assert tk.bin_gather_route(corpus.dtype, row_bytes) == "cuda_core"
    wrappers = (tk.binmax, tk.binmax_strided, tk.bin_gather)
    before = tuple(w.launches for w in wrappers)
    tc_before = tuple(w.tc_launches for w in wrappers)
    m_got = tk.binmax(q_in, corpus, scales)
    m_want = tk.binmax_plain(q_in, corpus, scales)
    got, rows = tk.binmax_strided(q_in, corpus, scales, 20_001, 11)
    want, _ = tk.binmax_strided_plain(q_in, corpus, scales, 20_001, 11)
    bins = tk.topk_stable(m_want.T, 10)[1].to(torch.int32)
    g_got = tk.bin_gather(q_in, q_scale, corpus, scales, bins.contiguous())
    g_want = tk.bin_gather_plain(q_in, q_scale, corpus, scales, bins)
    torch.cuda.synchronize()
    assert tuple(w.launches for w in wrappers) == tuple(n + 1 for n in before)
    assert tuple(w.tc_launches for w in wrappers) == tc_before
    tol = 1e-5 if dtype == "f32" else 0.0
    assert (m_got - m_want).abs().max().item() <= tol
    assert (got - want).abs().max().item() <= tol and (g_got - g_want).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# The tensor-core route of binmax, and the f32 routes of binmax and binmax_strided
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,d", [(1, 384), (8, 48), (16, 384), (17, 384), (32, 1024),
                                 (64, 384), (65, 64), (256, 384)])
def test_binmax_tensor_core_route_is_bit_for_bit(B, d):
    """int8 takes the tensor-core route: bin maxima bit for bit with the plain
    version, a ragged last bin, a valid_n that leaves it with no valid row and
    the bin before it partly valid, rows of 48 to 1,024 bytes, query counts
    that fill no 8-query group or chunk, and bitwise equal over two launches."""
    _need_card()
    n = 70_001  # 547 bins, the last of 113 rows
    x, q = _data(n, d, B, seed=400 + B + d)
    q[0] = x[4999]
    corpus, scales = _storage("int8", x)
    q_in, _ = tk.quantize_queries(q, corpus)
    assert tk.binmax_route(corpus.dtype, d) == "tc"
    for valid_n in (n, 546 * 128 - 3):
        before, tc_before = tk.binmax.launches, tk.binmax.tc_launches
        got = tk.binmax(q_in, corpus, scales, valid_n)
        again = tk.binmax(q_in, corpus, scales, valid_n)
        want = tk.binmax_plain(q_in, corpus, scales, valid_n)
        torch.cuda.synchronize()
        assert tk.binmax.launches == before + 2 and tk.binmax.tc_launches == tc_before + 2
        assert got.shape == (547, B)
        assert torch.equal(got, want) and torch.equal(again, got)
    assert (got[-1] == tk.NEG_INF).all() and (got[:-1] > tk.NEG_INF).all()


@pytest.mark.parametrize("d", [32, 384, 1024])
@pytest.mark.parametrize("B", [1, 7, 8, 9, 16, 17, 64, 65, 256])
def test_int4_tensor_core_routes_are_bit_for_bit(B, d):
    """Packed int4 rows of 16 to 512 bytes take the tensor-core kernels of
    binmax and binmax_strided: maxima (and the strided pass's rows) bit for
    bit with the plain versions, counted in tc_launches, over a ragged
    corpus with a valid_n that cuts a bin and leaves the last one empty, at
    query counts that fill no 8-query group or chunk."""
    _need_card()
    n = 70_001  # 547 bins, the last of 113 rows
    x, q = _data(n, d, B, seed=500 + B + d)
    q[0] = x[4999]
    corpus, scales = _storage("int4", x)
    q_in, _ = tk.quantize_queries(q, corpus)
    assert corpus.dtype == torch.uint8 and corpus.shape[1] == d // 2
    assert tk.binmax_route(corpus.dtype, d // 2) == "tc"
    assert tk.binmax_strided_route(corpus.dtype, d // 2) == "tc"
    valid_n = 546 * 128 - 3
    counts = (tk.binmax.launches, tk.binmax.tc_launches, tk.binmax_strided.launches,
              tk.binmax_strided.tc_launches)
    got = tk.binmax(q_in, corpus, scales, valid_n)
    s_got, s_rows = tk.binmax_strided(q_in, corpus, scales, valid_n, 133)
    want = tk.binmax_plain(q_in, corpus, scales, valid_n)
    s_want, s_want_rows = tk.binmax_strided_plain(q_in, corpus, scales, valid_n, 133)
    torch.cuda.synchronize()
    assert (tk.binmax.launches, tk.binmax.tc_launches, tk.binmax_strided.launches,
            tk.binmax_strided.tc_launches) == tuple(c + 1 for c in counts)
    assert got.shape == (547, B) and torch.equal(got, want)
    assert (got[-1] == tk.NEG_INF).all() and (got[:-1] > tk.NEG_INF).all()
    assert torch.equal(s_got, s_want) and torch.equal(s_rows, s_want_rows)


@pytest.mark.parametrize("B,d,scaled", [(1, 384, False), (9, 384, True), (16, 1024, False),
                                        (40, 384, False), (64, 128, True), (65, 384, False),
                                        (256, 384, True), (17, 4100, True), (5, 10_000, False)])
def test_f32_routes_of_binmax_and_binmax_strided_within_1e5(B, d, scaled):
    """f32 takes the register-tiled CUDA-core kernels of both wrappers: maxima
    within 1e-5 of the plain versions (another summation order), the strided
    rows holding their maxima, the lower of two equal rows in one bin, a
    ragged last bin and a last tile of no valid row; rows of any length
    (10,000 floats are staged in three bands, the last ragged)."""
    _need_card()
    n, blocks = 70_001, 100
    x, q = _data(n, d, B, seed=500 + B + d)
    x[4999 + 128 * blocks] = x[4999]
    q[0] = x[4999]
    scales = None
    if scaled:
        g = torch.Generator(device="cuda").manual_seed(B)
        scales = torch.rand(n, device="cuda", generator=g) + 0.5
        scales[4999 + 128 * blocks] = scales[4999]
    valid_n = n - 200
    assert tk.binmax_route(torch.float32, 4 * d) == "cuda_core"
    before = (tk.binmax.launches, tk.binmax_strided.launches)
    got = tk.binmax(q, x, scales, valid_n)
    want = tk.binmax_plain(q, x, scales, valid_n)
    top, rows = tk.binmax_strided(q, x, scales, valid_n, blocks)
    w_top, w_rows = tk.binmax_strided_plain(q, x, scales, valid_n, blocks)
    torch.cuda.synchronize()
    assert (tk.binmax.launches, tk.binmax_strided.launches) == (before[0] + 1, before[1] + 1)
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got <= tk.NEG_INF / 2, want <= tk.NEG_INF / 2)
    assert (top - w_top).abs().max().item() <= 1e-5
    assert (rows == w_rows).float().mean().item() >= 0.9999
    assert int(rows[4999 % (128 * blocks), 0]) == 4999
    live = top > tk.NEG_INF / 2  # each row named holds its bin's maximum
    picked = torch.einsum("gbd,bd->gb", x[rows.long().clamp(max=valid_n - 1)], q)
    if scales is not None:
        picked = picked * scales[rows.long().clamp(max=valid_n - 1)]
    torch.testing.assert_close(picked[live], top[live], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The bf16 routes: bf16 rows against f32 queries (binmax, binmax_strided,
# bin_gather), the bf16-rounded query (cell_gather, cell_gather_b1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,d", [(1, 384), (9, 384), (16, 64), (40, 384), (64, 1024),
                                 (256, 384), (5, 10_000)])
def test_bf16_routes_of_binmax_and_binmax_strided(B, d):
    """bf16 rows take the f32 tile with its row type bf16 (the "bf16" route,
    counted in bf16_launches): each score the in-order fma chain over the
    widened row, so the maxima equal the CPU emulation of that chain bit for
    bit (tests/torch_tc_emulation.py) and lie within 1e-5 of the plain
    versions; the strided rows hold their maxima, the lower of two equal
    rows in one bin; rows of any length (10,000 values in bands)."""
    from torch_tc_emulation import binmax_f32, binmax_strided_f32

    _need_card()
    n, blocks = 20_001, 30
    x, q = _data(n, d, B, seed=600 + B + d)
    x[4999 + 128 * blocks] = x[4999]
    q[0] = x[4999]
    corpus, _ = _storage("bf16", x)
    valid_n = n - 200
    assert tk.binmax_route(corpus.dtype, 2 * d) == tk.binmax_strided_route(corpus.dtype, 2 * d)
    assert tk.binmax_route(corpus.dtype, 2 * d) == "bf16"
    q_in, q_scale = tk.quantize_queries(q, corpus)
    assert q_in.dtype == torch.float32 and q_scale is None
    before = (tk.binmax.launches, tk.binmax.bf16_launches, tk.binmax_strided.bf16_launches)
    got = tk.binmax(q_in, corpus, None, valid_n)
    top, rows = tk.binmax_strided(q_in, corpus, None, valid_n, blocks)
    torch.cuda.synchronize()
    assert (tk.binmax.launches, tk.binmax.bf16_launches,
            tk.binmax_strided.bf16_launches) == tuple(v + 1 for v in before)
    want = tk.binmax_plain(q_in, corpus, None, valid_n)
    w_top, _ = tk.binmax_strided_plain(q_in, corpus, None, valid_n, blocks)
    assert (got - want).abs().max().item() <= 1e-5
    assert (top - w_top).abs().max().item() <= 1e-5
    if d <= 1024:  # the emulation walks the depth in Python
        cpu = corpus.cpu()
        assert torch.equal(got.cpu(), binmax_f32(q_in.cpu(), cpu, None, valid_n))
        e_top, e_rows = binmax_strided_f32(q_in.cpu(), cpu, None, valid_n, blocks)
        assert torch.equal(top.cpu(), e_top) and torch.equal(rows.cpu(), e_rows)
    assert int(rows[4999 % (128 * blocks), 0]) == 4999


@pytest.mark.parametrize("B,kb,d", [(1, 10, 384), (16, 10, 384), (64, 40, 384), (3, 7, 64),
                                    (2, 12, 1040)])
def test_bf16_route_of_bin_gather(B, kb, d):
    """bin_gather over bf16 rows: no scales, the f32 query. Rows of at most
    1,024 bytes take the tensor-core kernel (the "bf16_tc" route, counted in
    bf16_launches and tc_launches): the query split exactly into three bf16
    terms, each step's sum truncated to f32, so within 1e-5 of the plain
    version and of the CPU emulation of that arithmetic; longer rows take
    bin_gather_kernel's bf16 mode (the "bf16" route), each score the
    in-order fma chain over the widened row, bit for bit with the CPU
    emulation. Rows past valid_n at the sentinel."""
    from torch_tc_emulation import bin_gather_bf16_tc, f32_tile_scores

    _need_card()
    n = 20_001
    x, q = _data(n, d, B, seed=700 + B + d)
    corpus, _ = _storage("bf16", x)
    valid_n = n - 9
    route = tk.bin_gather_route(corpus.dtype, 2 * d)
    assert route == ("bf16_tc" if 2 * d <= tk.TC_MAX_ROW_BYTES else "bf16")
    _, bins = tk.topk_stable(tk.binmax_plain(q, corpus, None, valid_n).T, kb)
    bins = bins.to(torch.int32).contiguous()
    before = (tk.bin_gather.launches, tk.bin_gather.bf16_launches, tk.bin_gather.tc_launches)
    got = tk.bin_gather(q, None, corpus, None, bins, valid_n)
    torch.cuda.synchronize()
    assert (tk.bin_gather.launches, tk.bin_gather.bf16_launches,
            tk.bin_gather.tc_launches) == (before[0] + 1, before[1] + 1,
                                           before[2] + (route == "bf16_tc"))
    want = tk.bin_gather_plain(q, None, corpus, None, bins, valid_n)
    assert (got - want).abs().max().item() <= 1e-5
    if route == "bf16_tc":
        emu = bin_gather_bf16_tc(q.cpu(), corpus.cpu(), None, bins.cpu(), valid_n)
        assert (got.cpu() - emu).abs().max().item() <= 1e-5
        assert torch.equal(got.cpu() == tk.NEG_INF, emu == tk.NEG_INF)
        return
    rows = (bins.long()[:, :, None] * 128 + torch.arange(128, device="cuda")).view(B, -1)
    scores = f32_tile_scores(q.cpu(), corpus.cpu())  # [N, B]
    safe = rows.clamp(max=n - 1).cpu()
    emu = torch.where(rows.cpu() < valid_n, scores[safe, torch.arange(B)[:, None]], tk.NEG_INF)
    assert torch.equal(got.view(B, -1).cpu(), emu)


@pytest.mark.parametrize("B,nprobe,rpc,d", [(1, 64, 1024, 384), (1, 11, 768, 384),
                                            (16, 8, 1024, 384), (64, 5, 200, 48),
                                            (3, 11, 768, 64)])
def test_bf16_routes_of_the_cell_gathers(B, nprobe, rpc, d):
    """cell_gather and cell_gather_b1 over bf16 rows (CELL_BF16, the "bf16"
    route of both): the query rounded to bf16 by cell_queries, within 1e-5
    of the plain versions (the products are exact; the sums run in another
    order), and the general kernel gives one query what it gives a batch."""
    from sskd_tpu_torch.ops import topk_cluster as tc

    _need_card()
    q, corpus, scales, probe = _cells("bf16", 70, rpc, d, B, nprobe, seed=B * 10 + nprobe)
    q_in, q_scale = tc.cell_queries(q, corpus)
    assert q_in.dtype == torch.bfloat16 and q_scale is None and scales is None
    assert tc.cell_gather_route(corpus.dtype, 2 * d) == "bf16"
    wrapper, plain = ((tc.cell_gather_b1, tc.cell_gather_b1_plain) if B == 1
                      else (tc.cell_gather, tc.cell_gather_plain))
    before = (wrapper.launches, wrapper.bf16_launches)
    got = wrapper(q_in, None, corpus, None, probe, rpc)
    want = plain(q_in, None, corpus, None, probe, rpc)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (B, nprobe, rpc) and (got - want).abs().max().item() <= 1e-5
    if B > 1:
        one = tc.cell_gather(q_in[:1], None, corpus, None, probe[:1], rpc)
        assert torch.equal(one, got[:1])


def test_bf16_engines_match_their_plain_versions():
    """Exact, approx and clustered search over bf16 rows on the card against
    the same engines over the plain versions: ids equal but at near-ties,
    every launch on a bf16 route."""
    from sskd_tpu_torch.ops import bf16_launch_counts, launch_counts
    from sskd_tpu_torch.ops import topk_cluster as tc
    from sskd_tpu_torch.ops.topk import approx_topk, cosine_topk, cosine_topk_core

    _need_card()
    n_cells, rpc, n = 100, 1024, 100 * 1024 - 300
    q, corpus, _, _ = _cells("bf16", n_cells, rpc, 384, 16, 1, seed=8)
    cent = corpus.view(n_cells, rpc, -1).float().mean(dim=1)
    cent = cent / cent.norm(dim=1, keepdim=True)
    before, bf_before = launch_counts(), bf16_launch_counts()
    pairs = [
        (cosine_topk(q, corpus, 10, valid_n=n), cosine_topk_core(q, corpus, 10, valid_n=n)),
        # at 0.95 the approx engine reduces 798 tiles (at 0.99 it needs 896: exact)
        (cosine_topk(q, corpus, 10, valid_n=n, method="approx", recall_target=0.95),
         approx_topk(q, corpus, 10, valid_n=n, recall_target=0.95, kernels=False)),
    ]
    for B in (1, 16):
        pairs.append((tc.clustered_topk(q[:B], corpus, cent, 10, 16, rpc, valid_n=n),
                      tc.clustered_topk(q[:B], corpus, cent, 10, 16, rpc, valid_n=n,
                                        kernels=False)))
    torch.cuda.synchronize()
    for (kv, ki), (pv, pi) in pairs:
        torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-6)
        assert (ki == pi).float().mean().item() > 0.99 and (ki < n).all()
    after, bf_after = launch_counts(), bf16_launch_counts()
    for name in ("binmax", "bin_gather", "binmax_strided", "cell_gather", "cell_gather_b1"):
        assert after[name] - before[name] == bf_after[name] - bf_before[name] >= 1, name


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_refined_engine_on_the_card_under_high_matmul_precision(dtype):
    """The refined engine on the card, with torch.set_float32_matmul_precision
    ("high") set (TF32 for f32 matrix products), against the same engine over
    the plain versions at "highest": the rescore is an elementwise product
    and an f32 sum, so the scores agree within 1e-6 and the ids are equal.
    int8 candidates come from the approx pass on the tensor cores, int4 from
    the exact kernel engine, its binmax and bin_gather on the tensor cores."""
    from sskd_tpu_torch.ops import tc_launch_counts, launch_counts
    from sskd_tpu_torch.ops.topk import refined_topk, refined_topk_core

    _need_card()
    x, q = _data(300_000, 384, 64, seed=9 if dtype == "int8" else 10)
    corpus, scales = _storage(dtype, x)
    rows = x.to(torch.bfloat16)
    want = refined_topk_core(q, corpus, rows, 10, refine_m=40, row_scales=scales,
                             kernels=False)
    before, tc_before = launch_counts(), tc_launch_counts()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = refined_topk(q, corpus, rows, 10, refine_m=40, row_scales=scales)
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(saved)
    after, tc_after = launch_counts(), tc_launch_counts()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    assert torch.equal(got[1], want[1])
    if dtype == "int8":
        assert tc_after["binmax_strided"] - tc_before["binmax_strided"] == 1
        assert after["binmax_strided"] - before["binmax_strided"] == 1
    else:
        assert after["binmax"] - before["binmax"] == 1 and after["bin_gather"] - before[
            "bin_gather"] == 1
        assert tc_after["binmax"] - tc_before["binmax"] == 1
        assert tc_after["bin_gather"] - tc_before["bin_gather"] == 1


# ---------------------------------------------------------------------------
# The attention kernels at head dim 64 (the teacher's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [64, 130, 512])
def test_dropattn_head_dim_64_matches_plain(dtype, p, L):
    """Head dim 64: the forward on the tensor cores (f32 streaming K and V
    in tiles of 64 keys, bf16 holding the head's K and V), the backward on
    the tensor cores, holding the head in a block where it fits (64 in both
    dtypes, 130 in bf16) and streaming it past that: f32 within 1e-5, bf16
    each element within its rounding bound, the lse within 1e-5."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(2, 4, L, 64, dtype, seed=640 + L)
    seed = 64 + L
    assert ta.dropattn_fwd_route(dtype, 64, L) == "tc"
    b_route = ta.dropattn_bwd_route(dtype, 64, L)
    assert b_route == ("tc" if L <= ta.DROPATTN_TC_MAX_L[(dtype, 64)] else "tc_stream")
    before = (dict(ta.dropattn_fwd.head_dim_launches), ta.dropattn_fwd.tc_launches,
              ta.dropattn_bwd.tc_launches)
    out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
    want_grads = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
    torch.cuda.synchronize()
    assert ta.dropattn_fwd.head_dim_launches[64] == before[0].get(64, 0) + 1
    assert ta.dropattn_fwd.tc_launches == before[1] + 1
    assert ta.dropattn_bwd.tc_launches == before[2] + 1
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
    if dtype == torch.float32:
        assert (out - want).abs().max().item() <= 1e-5
        for a, b in zip(grads, want_grads):
            assert (a - b).abs().max().item() <= 1e-5
        return
    bound = ta.dropattn_fwd_error_bound(q, k, v, bias, p, seed, out, want)
    assert bool(((out.float() - want.float()).abs() <= bound).all())
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, grads, want_grads)
    for name, a, b, bd in zip("dq dk dv".split(), grads, want_grads, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


def test_dropattn_head_dim_64_bf16_beyond_the_resident_length():
    """bf16 at L = 1000: past the forward's tensor-core length (656), so the
    CUDA-core forward streams K and V in chunks, and the backward streams
    the head on the tensor cores; within the rounding bounds."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(1, 2, 1000, 64, torch.bfloat16, seed=1000)
    out, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 5)
    grads = ta.dropattn_bwd(q, k, v, bias, 0.1, 5, lse, go)
    want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, 0.1, 5)
    want_grads = ta.dropattn_bwd_plain(q, k, v, bias, 0.1, 5, lse, go)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
    bound = ta.dropattn_fwd_error_bound(q, k, v, bias, 0.1, 5, out, want)
    assert bool(((out.float() - want.float()).abs() <= bound).all())
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, 0.1, 5, lse, go, grads, want_grads)
    for a, b, bd in zip(grads, want_grads, bounds):
        assert bool(((a.float() - b.float()).abs() <= bd).all())


@pytest.mark.parametrize("L", [256, 512, 64, 128])
def test_dropattn_head_dim_64_kernels_apply_the_plain_mask(L):
    """f32 at head dim 64, q = k = 0 and a zero bias: each probability is
    1/L, each kept pd 2/L at p = 0.5; v (and g) holding 2^(j % 8) in channel
    j // 8 make out (dv) spell each row's (column's) keep bits, read back
    bit for bit. The forward is the tensor-core kernel (one launch on the
    route) at every L; past L = 128 the backward streams the head (the keep
    bits drawn by its first kernel, read by the other two)."""
    _need_card()
    B, h, d, seed = 2, 3, 64, 123
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda")
    bias = torch.zeros(B, L, device="cuda")
    before = ta.dropattn_fwd.tc_launches
    out, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    assert ta.dropattn_fwd.tc_launches == before + 1
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    bit = torch.arange(8, device="cuda")

    def spell(x):  # [B, h, L, 64] sums of 2^bit * 2 / L -> [B, h, L, L] bits
        n = (x[..., : L // 8] * (L / 2)).round().long()
        return ((n[..., None] >> bit) & 1).reshape(B, h, L, L).bool()

    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    assert bool((spell(out) == want).all())
    assert bool((spell(dv).transpose(-1, -2) == want).all())


def test_dropattn_head_dim_64_is_bitwise_repeatable():
    _need_card()
    q, k, v, go, bias = _attn_inputs(4, 16, 64, 64, torch.float32, seed=17)
    first = ta.dropattn_fwd(q, k, v, bias, 0.1, 9)
    second = ta.dropattn_fwd(q, k, v, bias, 0.1, 9)
    g1 = ta.dropattn_bwd(q, k, v, bias, 0.1, 9, first[1], go)
    g2 = ta.dropattn_bwd(q, k, v, bias, 0.1, 9, first[1], go)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_head_dim_routes_and_counters():
    """At head dim 64 flash and both dropattn kernels take the tensor cores
    in bf16 and f32; at head dims 32 and 16 bf16 takes the tensor cores
    throughout; the launches are counted by head dim and on the tensor-core
    route."""
    from sskd_tpu_torch.ops import head_dim_launch_counts, reset_launch_counts, tc_launch_counts

    _need_card()
    for dtype in (torch.bfloat16, torch.float32):
        assert ta.dropattn_fwd_route(dtype, 64, 64) == "tc"
        assert ta.dropattn_bwd_route(dtype, 64, 64) == ta.flash_route(dtype, 64) == "tc"
    assert ta.dropattn_fwd_route(torch.bfloat16, 32, 64) == "tc"
    assert ta.dropattn_fwd_route(torch.bfloat16, 16, 64) == "tc"
    assert ta.dropattn_bwd_route(torch.bfloat16, 16, 64) == "tc"
    reset_launch_counts()
    for d, dtype in ((32, torch.bfloat16), (64, torch.bfloat16), (64, torch.float32),
                     (16, torch.bfloat16)):
        q, k, v, go, bias = _attn_inputs(2, 3, 64, d, dtype, seed=d)
        _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 3)
        ta.dropattn_bwd(q, k, v, bias, 0.1, 3, lse, go)
        ta.flash_attention(q, k, v)
    torch.cuda.synchronize()
    by_d, tc = head_dim_launch_counts(), tc_launch_counts()
    assert by_d == {name: {32: 1, 64: 2, 16: 1}
                    for name in ("flash_attn_fwd", "dropattn_fwd", "dropattn_bwd")}
    # flash at head dim 16 runs on the tensor cores too (flash_route)
    assert tc["dropattn_fwd"] == tc["dropattn_bwd"] == 4 and tc["flash_attn_fwd"] == 4
    reset_launch_counts()
    assert head_dim_launch_counts() == {"flash_attn_fwd": {}, "dropattn_fwd": {},
                                        "dropattn_bwd": {}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [200, 512, 64])  # 200: a ragged last tile of 64 keys
def test_flash_head_dim_64_tensor_core_routes(dtype, L):
    """Flash at head dim 64 on its tensor-core route (three TF32 products in
    f32): one launch counted on the route and at d = 64, two launches
    bitwise equal, f32 within 1e-5 and bf16 within the rounding bound, with
    a half row, one live key and no live key."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(L + 64)
    q, k, v = (torch.randn(4, 16, L, 64, device="cuda", generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([L, L // 2, 1, 0], device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).to(torch.int32)
    before = (ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches.get(64, 0))
    got = ta.flash_attention(q, k, v, mask)
    assert (ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches[64]) == (
        before[0] + 1, before[1] + 1)
    again = ta.flash_attention(q, k, v, mask)
    want = ta.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        bound = ta.flash_error_bound(q, k, v, mask, got, want)
        assert bool((diff <= bound).all()), (diff / bound).max().item()


def _limit(dtype):
    return ta.DROPATTN_TC_MAX_L[(dtype, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [64, 100, "limit"])  # 100: a ragged last chunk of 16 keys
def test_dropattn_bwd_head_dim_64_tensor_core_route(dtype, p, L):
    """The backward at head dim 64 on the tensor cores, at the teacher's
    train length, a ragged one and the longest the route takes (208 in
    bf16, 128 in f32): one launch on the route, two launches bitwise equal,
    f32 within 1e-5 of the plain version, bf16 within its rounding bound."""
    _need_card()
    L = _limit(dtype) if L == "limit" else L
    q, k, v, go, bias = _attn_inputs(4, 16, L, 64, dtype, seed=700 + L)
    seed = 70 + L
    _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    before = ta.dropattn_bwd.tc_launches
    grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    assert ta.dropattn_bwd.tc_launches == before + 1
    again = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    if dtype == torch.float32:
        for name, a, b in zip("dq dk dv".split(), grads, want):
            assert (a - b).abs().max().item() <= 1e-5, name
        return
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, grads, want)
    for name, a, b, bd in zip("dq dk dv".split(), grads, want, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropattn_bwd_head_dim_64_route_edge(dtype):
    """The next L after the resident limit goes to the streaming kernels
    (counted on the tensor cores and on the streaming route, within the same
    checks), and the resident kernel itself refuses a head one chunk of 16
    past its limit."""
    import ctypes

    from sskd_tpu_torch.ops import _build

    _need_card()
    L = _limit(dtype) + 1
    q, k, v, go, bias = _attn_inputs(2, 4, L, 64, dtype, seed=L)
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 5)
    before = (ta.dropattn_bwd.launches, ta.dropattn_bwd.tc_launches,
              ta.dropattn_bwd.stream_launches)
    grads = ta.dropattn_bwd(q, k, v, bias, 0.1, 5, lse, go)
    assert (ta.dropattn_bwd.launches, ta.dropattn_bwd.tc_launches,
            ta.dropattn_bwd.stream_launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    want = ta.dropattn_bwd_plain(q, k, v, bias, 0.1, 5, lse, go)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert max((a - b).abs().max().item() for a, b in zip(grads, want)) <= 1e-5
    else:
        bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, 0.1, 5, lse, go, grads, want)
        assert all(bool(((a.float() - b.float()).abs() <= bd).all())
                   for a, b, bd in zip(grads, want, bounds))
    fn = _build.load_library("dropattn_bwd").sskd_dropattn_bwd_tc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    outs = [torch.empty_like(q) for _ in range(3)]
    rc = fn(int(dtype == torch.bfloat16), *(ctypes.c_void_p(t.data_ptr()) for t in
                                            (q, k, v, bias, go, lse, *outs)),
            2, 4, _limit(dtype) + 16, 64, 0.125, 0.18, 5, 0.1, 1 / 0.9,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc != 0


@pytest.mark.parametrize("L", [64, 128])
def test_dropattn_head_dim_64_f32_tensor_core_backward_applies_the_plain_mask(L):
    """The read-back of test_dropattn_head_dim_64_kernels_apply_the_plain_mask
    through the f32 tensor-core backward (L <= 128): q = k = 0, each kept pd
    2/L at p = 0.5, g holding 2^(j % 8) in channel j // 8, so dv spells each
    column's keep bits over the L rows, bit for bit."""
    _need_card()
    B, h, d, seed = 2, 16, 64, 321
    j = torch.arange(L, device="cuda")
    code = torch.zeros(L, d, device="cuda")
    code[j, j // 8] = (2.0 ** (j % 8)).float()
    code = code.expand(B, h, L, d).contiguous()
    zero = torch.zeros(B, h, L, d, device="cuda")
    bias = torch.zeros(B, L, device="cuda")
    _, lse = ta.dropattn_fwd(zero, zero, code, bias, 0.5, seed)
    before = ta.dropattn_bwd.tc_launches
    _, _, dv = ta.dropattn_bwd(zero, zero, code, bias, 0.5, seed, lse, code)
    assert ta.dropattn_bwd.tc_launches == before + 1
    bit = torch.arange(8, device="cuda")
    n = (dv[..., : L // 8] * (L / 2)).round().long()
    spelled = ((n[..., None] >> bit) & 1).reshape(B, h, L, L).bool()
    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    assert bool((spelled.transpose(-1, -2) == want).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_64_at_the_rerank_length(dtype):
    """The teacher's scoring shape at L = 512: flash at head dim 64 on its
    tensor-core route, f32 within 1e-5 and bf16 within its rounding bound."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(64)
    q, k, v = (torch.randn(4, 16, 512, 64, device="cuda", generator=g).to(dtype)
               for _ in range(3))
    lens = torch.tensor([512, 300, 1, 0], device="cuda")
    mask = (torch.arange(512, device="cuda")[None] < lens[:, None]).to(torch.int32)
    assert ta.flash_route(dtype, 64) == "tc"
    got = ta.flash_attention(q, k, v, mask)
    want = ta.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        bound = ta.flash_error_bound(q, k, v, mask, got, want)
        assert bool((diff <= bound).all()), (diff / bound).max().item()


# ---------------------------------------------------------------------------
# The tensor-core dropattn_fwd at head dim 64 (f32 as three TF32 products,
# and bf16)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,L", [(32, 64), (8, 512)])
def test_dropattn_fwd_head_dim_64_tensor_core_route(dtype, p, B, L):
    """The forward at head dim 64 on the tensor cores at the teacher's train
    shape [32, 16, 64, 64] and at [8, 16, 512, 64]: one launch on the route
    at d = 64, two launches bitwise equal, f32 within 1e-5 of the plain
    version and bf16 within dropattn_fwd_error_bound, the lse within
    1e-4."""
    _need_card()
    q, k, v, _, bias = _attn_inputs(B, 16, L, 64, dtype, seed=800 + L)
    seed = 80 + L
    assert ta.dropattn_fwd_route(dtype, 64, L) == "tc"
    before = (ta.dropattn_fwd.tc_launches, ta.dropattn_fwd.head_dim_launches.get(64, 0))
    out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    assert (ta.dropattn_fwd.tc_launches, ta.dropattn_fwd.head_dim_launches[64]) == (
        before[0] + 1, before[1] + 1)
    again = ta.dropattn_fwd(q, k, v, bias, p, seed)
    want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert (lse - want_lse).abs().max().item() <= 1e-4
    if dtype == torch.float32:
        assert (out - want).abs().max().item() <= 1e-5
        return
    diff = (out.float() - want.float()).abs()
    bound = ta.dropattn_fwd_error_bound(q, k, v, bias, p, seed, out, want)
    assert bool((diff <= bound).all()), (diff / bound).max().item()


@pytest.mark.parametrize("d", [16, 32, 64])
def test_dropattn_fwd_bf16_tensor_core_route_edge(d):
    """The bf16 forward's limit (the longest L whose head's K and V fit a
    block) takes the tensor cores; the next L the CUDA-core kernel, both
    within dropattn_fwd_error_bound; the tensor-core kernel itself refuses a
    head one chunk of 16 past the limit."""
    import ctypes

    from sskd_tpu_torch.ops import _build

    _need_card()
    limit = ta.DROPATTN_FWD_TC_MAX_L[(torch.bfloat16, d)]
    for L, tc in ((limit, 1), (limit + 1, 0)):
        q, k, v, _, bias = _attn_inputs(1, 2, L, d, torch.bfloat16, seed=L + d)
        before = (ta.dropattn_fwd.launches, ta.dropattn_fwd.tc_launches)
        out, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 5)
        assert (ta.dropattn_fwd.launches, ta.dropattn_fwd.tc_launches) == (
            before[0] + 1, before[1] + tc)
        want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, 0.1, 5)
        torch.cuda.synchronize()
        assert (lse - want_lse).abs().max().item() <= 1e-4
        bound = ta.dropattn_fwd_error_bound(q, k, v, bias, 0.1, 5, out, want)
        assert bool(((out.float() - want.float()).abs() <= bound).all())
    fn = _build.load_library("dropattn_fwd").sskd_dropattn_fwd_tc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    L = limit + 16
    q = torch.zeros(1, 1, L, d, device="cuda", dtype=torch.bfloat16)
    bias, out = torch.zeros(1, L, device="cuda"), torch.empty_like(q)
    lse = torch.empty(1, 1, L, device="cuda")
    rc = fn(1, *(ctypes.c_void_p(t.data_ptr()) for t in (q, q, q, bias, out, lse)),
            1, 1, L, d, d**-0.5, ta._scale_log2(d), 5, 0.1, 1 / 0.9,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc != 0


# ---------------------------------------------------------------------------
# The streaming tensor-core dropattn_bwd ("tc_stream": three kernels, any L)
# ---------------------------------------------------------------------------

# (dtype, B, h, L, d): the kernel phase's long shapes (B cut), and ragged ones
STREAM_SHAPES = [(torch.bfloat16, 16, 12, 512, 32), (torch.float32, 8, 16, 512, 64),
                 (torch.bfloat16, 8, 16, 512, 64), (torch.float32, 8, 16, 200, 64),
                 (torch.bfloat16, 8, 16, 216, 64), (torch.bfloat16, 32, 12, 264, 32),
                 (torch.float32, 32, 12, 192, 32), (torch.float32, 4, 12, 72, 32),
                 (torch.float32, 2, 3, 33, 32)]


def _grads_within(dtype, q, k, v, bias, p, seed, lse, go, grads, want):
    """f32: within 1e-5 (1 + |want|). _attn_inputs gives some batch rows one
    live key, whose probability 1 at every query makes that key's dv a sum
    of L terms of size |g| (|dv| up to tens at L = 512); two f32 sums of
    that size, the plain product's own included, differ by a few ulps of
    it, which passes 1e-5 there (1.3e-5 on an H100 at [8, 16, 512, 64]).
    bf16: within dropattn_bwd_error_bound."""
    if dtype == torch.float32:  # summation order, and the TF32 terms' truncation
        for name, a, b in zip("dq dk dv".split(), grads, want):
            ratio = ((a - b).abs() / (1 + b.abs())).max().item()
            assert ratio <= 1e-5, (name, ratio, b.abs().max().item())
        return
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, grads, want)
    for name, a, b, bd in zip("dq dk dv".split(), grads, want, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,B,h,L,d", STREAM_SHAPES)
def test_streaming_backward_matches_plain(dtype, B, h, L, d, p):
    """The streaming route: one launch counted on the tensor cores and on
    the streaming route, two launches bitwise equal, f32 within 1e-5
    (1 + |want|) of the plain version and bf16 within
    dropattn_bwd_error_bound (_grads_within)."""
    _need_card()
    assert ta.dropattn_bwd_route(dtype, d, L) == "tc_stream"
    q, k, v, go, bias = _attn_inputs(B, h, L, d, dtype, seed=900 + L + d)
    seed = 90 + L
    _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    before = (ta.dropattn_bwd.launches, ta.dropattn_bwd.tc_launches,
              ta.dropattn_bwd.stream_launches)
    grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    assert (ta.dropattn_bwd.launches, ta.dropattn_bwd.tc_launches,
            ta.dropattn_bwd.stream_launches) == tuple(n + 1 for n in before)
    again = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _grads_within(dtype, q, k, v, bias, p, seed, lse, go, grads, want)


@pytest.mark.parametrize("dtype,B,h,L,d", [(torch.bfloat16, 4, 12, 512, 32),
                                           (torch.float32, 2, 16, 200, 64),
                                           (torch.float32, 2, 3, 33, 32)])
def test_streaming_first_kernel_writes_the_keep_bits_and_d(dtype, B, h, L, d):
    """K1's outputs: the keep bits packed as dropout_keep_bits lays them
    out (bit j % 32 of word j // 32, bits past L 0), bit for bit, and D =
    rowsum(dprobs * probs) within 1e-5 (1 + |D|) of the plain one."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(B, h, L, d, dtype, seed=L + 7)
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 61)
    dq, dk, dv, dsum, bits = ta._dropattn_bwd_stream(q, k, v, bias.float(), 0.1, 61, lse, go)
    torch.cuda.synchronize()
    assert torch.equal(bits, ta.dropout_keep_bits(61, B * h, L, 0.1, device="cuda"))
    qf, kf, vf, gf = (t.float().reshape(B * h, L, d) for t in (q, k, v, go))
    s = qf @ kf.transpose(-1, -2) / d**0.5 + bias.float().repeat_interleave(h, 0)[:, None, :]
    probs = torch.exp(s - lse.reshape(B * h, L, 1))
    keep = ta.dropout_keep_mask(61, B * h, L, 0.1, device="cuda")
    dprobs = torch.where(keep, (gf @ vf.transpose(-1, -2)) / 0.9, 0.0)
    want = (dprobs * probs).sum(-1).view(B, h, L)
    assert ((dsum - want).abs() / (1 + want.abs())).max().item() <= 1e-5


@pytest.mark.parametrize("dtype,B,h,L,d", [(torch.bfloat16, 8, 12, 192, 32),
                                           (torch.float32, 8, 16, 64, 64),
                                           (torch.bfloat16, 8, 16, 64, 64)])
def test_streaming_kernels_at_the_resident_lengths_match_plain(dtype, B, h, L, d):
    """The streaming kernels through their private entry at lengths the
    resident kernel takes (the route stays "tc" there): within the same
    tolerances of the plain version, one launch counted on the streaming
    route."""
    _need_card()
    assert ta.dropattn_bwd_route(dtype, d, L) == "tc"
    q, k, v, go, bias = _attn_inputs(B, h, L, d, dtype, seed=L + 11)
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 63)
    before = ta.dropattn_bwd.stream_launches
    grads = ta._dropattn_bwd_stream(q, k, v, bias.float(), 0.1, 63, lse, go)[:3]
    assert ta.dropattn_bwd.stream_launches == before + 1
    want = ta.dropattn_bwd_plain(q, k, v, bias, 0.1, 63, lse, go)
    torch.cuda.synchronize()
    _grads_within(dtype, q, k, v, bias, 0.1, 63, lse, go, grads, want)


def test_streaming_backward_applies_the_plain_mask_in_bf16():
    """bf16 at L = 512, head dim 32: a bias that leaves keys 0..255 live makes
    each live probability 1/256, so at p = 0.5 each kept pd is 1/128 exactly
    in bf16; g holding 2^(i % 8) in channel i // 8 for rows i of one half
    (two launches, 256 rows each) makes dv spell each live column's keep
    bits over all 512 rows: the bits K1 drew, read by K3, bit for bit."""
    _need_card()
    B, h, L, d, live, seed = 2, 3, 512, 32, 256, 77
    j = torch.arange(L, device="cuda")
    zero = torch.zeros(B, h, L, d, device="cuda", dtype=torch.bfloat16)
    bias = torch.where(j < live, 0.0, torch.finfo(torch.bfloat16).min / 2).expand(B, L)
    bias = bias.contiguous()
    _, lse = ta.dropattn_fwd(zero, zero, zero, bias, 0.5, seed)
    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    bit = torch.arange(8, device="cuda")
    for half in range(2):
        rows = j - 256 * half
        code = torch.zeros(L, d, device="cuda")
        mine = (rows >= 0) & (rows < 256)
        code[j[mine], rows[mine] // 8] = (2.0 ** (rows[mine] % 8)).float()
        code = code.to(torch.bfloat16).expand(B, h, L, d).contiguous()
        before = ta.dropattn_bwd.stream_launches
        _, _, dv = ta.dropattn_bwd(zero, zero, zero, bias, 0.5, seed, lse, code)
        assert ta.dropattn_bwd.stream_launches == before + 1
        c = (dv[:, :, :live].float() * 128).round().long()  # [B, h, live keys, 32 channels]
        spelled = ((c[..., None] >> bit) & 1).flatten(-2).bool()  # [B, h, live, 256 rows]
        assert bool((spelled == want[:, :, 256 * half:256 * half + 256, :live]
                     .transpose(-1, -2)).all())



# the one-live-key rows of tests/test_torch_dropattn_stream.py through every
# f32 kernel: the resident dropattn_bwd_tc_tf32_kernel<64> and the streaming
# kernels at head dims 16, 32 and 64
ONE_KEY_SHAPES = [(32, 16, 64, 64, "tc"), (8, 16, 512, 64, "tc_stream"),
                  (32, 12, 192, 32, "tc_stream"), (16, 4, 64, 16, "tc_stream")]


@pytest.mark.parametrize("B,h,L,d,route", ONE_KEY_SHAPES)
def test_f32_backwards_give_zero_dq_dk_on_one_live_key_rows(B, h, L, d, route):
    """Batch rows 1.. keep one key, so probs is one-hot there and dq and dk
    are exactly 0 (the float64 backward's, and the plain pair's, value).
    With lse from the plain forward, whose score products run in another
    order than the kernels', every f32 kernel gives dq and dk of at most
    2e-6 on those rows (1.08e-5 resident and 2.31e-5 streaming before D was
    divided by the row's sum of probs), and stays within 1e-5 (1 + |want|)
    of the plain pair on the full batch row 0. (dv on the one-key rows sums
    L rows of g, partial sums of tens: f32 noise of a few 1e-5 absolute on
    both sides, ROADMAP's recorded divergence; not this test's subject.)"""
    _need_card()
    assert ta.dropattn_bwd_route(torch.float32, d, L) == route
    g = torch.Generator(device="cuda").manual_seed(1000 + L + d)
    q, k, v, go = (torch.randn(B, h, L, d, device="cuda", generator=g) for _ in range(4))
    lens = torch.ones(B, dtype=torch.long, device="cuda")
    lens[0] = L
    keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min / 2)
    _, lse = ta.dropattn_fwd_plain(q, k, v, bias, 0.0, 3)
    got = ta.dropattn_bwd(q, k, v, bias, 0.0, 3, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, 0.0, 3, lse, go)
    torch.cuda.synchronize()
    for name, a in zip(("dq", "dk"), got):
        assert a[1:].abs().max().item() <= 2e-6, (name, a[1:].abs().max().item())
    _grads_within(torch.float32, q, k, v, bias, 0.0, 3, lse, go, [t[:1] for t in got],
                  [t[:1] for t in want])


# ---------------------------------------------------------------------------
# The f32 forwards at head dims 16 and 32 on the tensor cores
# (flash_fwd_tc_tf32_kernel<D>, dropattn_fwd_tc_tf32_kernel<D>)
# ---------------------------------------------------------------------------

# (B, h, L, d): the f32 student's train shape (B cut) and its encode length,
# one key tile (L = 64), a ragged one (33) and ragged several (130, 100),
# one key; the tiny teacher's [32, 4, 64, 16]
F32_SMALL_D_SHAPES = [(8, 12, 192, 32), (4, 12, 512, 32), (4, 12, 64, 32), (3, 5, 33, 32),
                      (3, 5, 130, 32), (2, 3, 1, 32), (32, 4, 64, 16), (3, 4, 100, 16),
                      (2, 3, 1, 16)]


@pytest.mark.parametrize("B,h,L,d", F32_SMALL_D_SHAPES)
def test_f32_forwards_at_head_dims_16_and_32_on_the_tensor_cores(B, h, L, d):
    """f32 dropattn_fwd (p 0 and 0.1, a padding bias) and flash (a ragged
    key mask with a row of one key and a row of none) at head dims 16 and 32
    take the tensor cores: one tensor-core launch a call counted at head dim
    d, two launches bitwise equal, out within 1e-5 of the plain version and
    the lse within 1e-4."""
    _need_card()
    q, k, v, _, bias = _attn_inputs(B, h, L, d, torch.float32, seed=900 + L + d)
    assert ta.dropattn_fwd_route(torch.float32, d, L) == ta.flash_route(torch.float32, d) == "tc"
    for p in (0.0, 0.1):
        seed = 90 + L
        before = (ta.dropattn_fwd.tc_launches, ta.dropattn_fwd.head_dim_launches.get(d, 0))
        out, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
        assert (ta.dropattn_fwd.tc_launches, ta.dropattn_fwd.head_dim_launches[d]) == (
            before[0] + 1, before[1] + 1)
        again = ta.dropattn_fwd(q, k, v, bias, p, seed)
        want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
        torch.cuda.synchronize()
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert (out - want).abs().max().item() <= 1e-5
        assert (lse - want_lse).abs().max().item() <= 1e-4
    lens = torch.tensor([L, max(1, L // 2), 1, 0] * B, device="cuda")[:B]
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).to(torch.int32)
    before = (ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches.get(d, 0))
    got = ta.flash_attention(q, k, v, mask)
    assert (ta.flash_attention.tc_launches, ta.flash_attention.head_dim_launches[d]) == (
        before[0] + 1, before[1] + 1)
    again = ta.flash_attention(q, k, v, mask)
    want = ta.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("d,L", [(32, 64), (32, 256), (16, 64), (16, 256)])
def test_f32_forward_at_head_dims_16_and_32_applies_the_plain_mask(d, L):
    """f32, q = k = 0 and a zero bias: each probability is 1/L, each kept pd
    2/L at p = 0.5, exact in f32 and in the TF32 terms. With v holding
    2^(j % 8) in channel (j // 8) % d for the keys j of one window of 8 d
    (0 elsewhere), out spells each row's keep bits over that window: the
    mask the tensor-core forward applied, read back bit for bit."""
    _need_card()
    B, h, seed = 2, 3, 73
    zero = torch.zeros(B, h, L, d, device="cuda")
    bias = torch.zeros(B, L, device="cuda")
    want = ta.dropout_keep_mask(seed, B * h, L, 0.5, device="cuda").view(B, h, L, L)
    j = torch.arange(L, device="cuda")
    bit = torch.arange(8, device="cuda")
    tc_before = ta.dropattn_fwd.tc_launches
    for w0 in range(0, L, 8 * d):
        n = min(8 * d, L - w0)
        code = torch.zeros(L, d, device="cuda")
        win = j[w0:w0 + n]
        code[win, (win - w0) // 8] = (2.0 ** (win % 8)).float()
        out, _ = ta.dropattn_fwd(zero, zero, code.expand(B, h, L, d).contiguous(), bias, 0.5,
                                 seed)
        c = (out * (L / 2)).round().long()[..., : n // 8]
        spelled = ((c[..., None] >> bit) & 1).flatten(-2).bool()
        assert bool((spelled == want[..., w0:w0 + n]).all())
    assert ta.dropattn_fwd.tc_launches == tc_before + (L + 8 * d - 1) // (8 * d)


@pytest.mark.parametrize("B,h,L,d", [(32, 12, 192, 32), (16, 4, 64, 16)])
def test_f32_backward_gives_zero_dq_dk_on_one_live_key_rows_with_the_kernel_lse(B, h, L, d):
    """As test_f32_backwards_give_zero_dq_dk_on_one_live_key_rows, with the
    lse of the tensor-core forward at head dims 32 and 16 (whose score
    products run in another order than the streaming backward's): on the
    rows that keep one key, dq and dk stay within 2e-6 of their exact 0, and
    the full batch row 0 within 1e-5 (1 + |want|) of the plain pair."""
    _need_card()
    assert ta.dropattn_fwd_route(torch.float32, d, L) == "tc"
    g = torch.Generator(device="cuda").manual_seed(2000 + L + d)
    q, k, v, go = (torch.randn(B, h, L, d, device="cuda", generator=g) for _ in range(4))
    lens = torch.ones(B, dtype=torch.long, device="cuda")
    lens[0] = L
    keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min / 2)
    tc_before = ta.dropattn_fwd.tc_launches
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.0, 3)
    assert ta.dropattn_fwd.tc_launches == tc_before + 1
    got = ta.dropattn_bwd(q, k, v, bias, 0.0, 3, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, 0.0, 3, lse, go)
    torch.cuda.synchronize()
    for name, a in zip(("dq", "dk"), got):
        assert a[1:].abs().max().item() <= 2e-6, (name, a[1:].abs().max().item())
    _grads_within(torch.float32, q, k, v, bias, 0.0, 3, lse, go, [t[:1] for t in got],
                  [t[:1] for t in want])


# ---------------------------------------------------------------------------
# f32 bin_gather on the tensor cores, and the three-pass bf16 backward at d = 16
# ---------------------------------------------------------------------------


def _f32_gather_case(n, valid_n, B, kb, d, scaled, seed):
    x, q = _data(n, d, B, seed=seed)
    scales = None
    if scaled:
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        scales = torch.rand(n, device="cuda", generator=g) + 0.5
    want_max = tk.binmax_plain(q, x, scales, valid_n)
    bins = tk.topk_stable(want_max.T, min(kb, want_max.shape[0]))[1].to(torch.int32)
    return x, q, scales, bins.contiguous()


def _f32_layout(sort, q, x, scales, bins, valid_n):
    """The f32 route's kernel in one layout, through its C entry."""
    B, kb = bins.shape
    out = torch.empty(B, kb, 128, device="cuda")
    order = tk.bin_order(bins, x.shape[0]) if sort else None
    rc = tk._fn("bin_gather", "sskd_bin_gather_f32_tc")(
        q.data_ptr(), x.data_ptr(), scales.data_ptr() if scales is not None else None,
        bins.data_ptr(), order.data_ptr() if order is not None else None, out.data_ptr(),
        B, kb, x.shape[0], x.shape[1], valid_n, tk._stream(x.device))
    assert rc == 0
    return out


@pytest.mark.parametrize("n,valid_n,B,kb,d,scaled", [
    (1_000_000, 1_000_000, 1, 10, 384, False),   # an f32 index's /search
    (1_000_000, 1_000_000, 16, 10, 384, False),
    (1_000_000, 999_950, 64, 10, 384, True),
    (8192, 8192, 1000, 20, 384, False),          # the evaluator: 64 bins, sorted
    (1900, 1850, 3, 4, 32, True),                # a ragged last bin cut by valid_n
    (5000, 5000, 40, 12, 1024, False),           # the longest row of the route, sorted
    (3000, 2990, 7, 3, 100, False),              # a partial last chunk of 32 floats
])
def test_f32_bin_gather_tensor_core_route_within_1e5(n, valid_n, B, kb, d, scaled):
    """bin_gather over f32 rows of at most 1,024 floats launches
    bin_gather_f32_tc_kernel (three TF32 products a product; counted in
    tc_launches, f32_tc_launches and, when it sorts the pairs by bin,
    sorted_launches), within 1e-5 of bin_gather_plain with the sentinel
    where the plain version has it; both layouts give the same bits, and two
    launches too."""
    _need_card()
    x, q, scales, bins = _f32_gather_case(n, valid_n, B, kb, d, scaled, seed=n % 997 + B)
    assert tk.bin_gather_route(x.dtype, 4 * d) == "f32_tc"
    sort = tk.bin_gather_f32_layout(bins.numel(), n) == "sorted"
    before = (tk.bin_gather.launches, tk.bin_gather.tc_launches, tk.bin_gather.f32_tc_launches,
              tk.bin_gather.sorted_launches, tk.bin_gather.bf16_launches)
    got = tk.bin_gather(q, None, x, scales, bins, valid_n)
    assert (tk.bin_gather.launches, tk.bin_gather.tc_launches, tk.bin_gather.f32_tc_launches,
            tk.bin_gather.sorted_launches, tk.bin_gather.bf16_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + sort, before[4])
    want = tk.bin_gather_plain(q, None, x, scales, bins, valid_n)
    torch.cuda.synchronize()
    dead = want == tk.NEG_INF
    assert torch.equal(got == tk.NEG_INF, dead)
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, tk.bin_gather(q, None, x, scales, bins, valid_n))
    for layout in (False, True):
        assert torch.equal(_f32_layout(layout, q, x, scales, bins, valid_n), got)


@pytest.mark.parametrize("n,B,k", [(1_000_000, 16, 10), (8192, 1000, 20), (100_000, 256, 100)])
def test_f32_kernel_engine_ids_match_the_plain_engine(n, B, k):
    """The exact engine over f32 rows through binmax and the f32 tensor-core
    gather gives cosine_topk_core's ids, ties within 1e-5 aside."""
    from sskd_tpu_torch.ops.topk import cosine_topk_core

    _need_card()
    x, q = _data(n, 384, B, seed=B + k)
    kv, ki = tk.cosine_topk_kernels(q, x, k)
    pv, pi = cosine_topk_core(q, x, k)
    torch.cuda.synchronize()
    assert (kv - pv).abs().max().item() <= 1e-5
    kth = pv[:, -1:]
    for r in range(B):
        a, b = set(ki[r].tolist()), set(pi[r].tolist())
        for i in a ^ b:  # an id in one set only scores within 1e-5 of the k-th
            row, ids = (kv, ki) if i in a else (pv, pi)
            assert abs(row[r][ids[r] == i].item() - kth[r].item()) <= 1e-5


def test_f32_bin_gather_routes_by_row_length():
    """f32 rows past 1,024 floats stay on bin_gather_kernel (counted in
    launches only), within 1e-5 of the plain version."""
    _need_card()
    x, q, scales, bins = _f32_gather_case(20_001, 20_001, 4, 10, 1028, False, seed=5)
    assert tk.bin_gather_route(x.dtype, 4 * 1028) == "cuda_core"
    before = (tk.bin_gather.launches, tk.bin_gather.tc_launches, tk.bin_gather.f32_tc_launches)
    got = tk.bin_gather(q, None, x, None, bins)
    assert (tk.bin_gather.launches, tk.bin_gather.tc_launches,
            tk.bin_gather.f32_tc_launches) == (before[0] + 1, before[1], before[2])
    want = tk.bin_gather_plain(q, None, x, None, bins)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L", [64, 130, 192, 256])
def test_three_pass_backward_at_head_dim_16_matches_plain(p, L):
    """bf16 at head dim 16 takes dropattn_bwd_tc_3pass_kernel (the resident
    route, counted in three_pass_launches): within dropattn_bwd_error_bound
    of the plain pair, and two launches give the same bits."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(6, 4, L, 16, torch.bfloat16, seed=700 + L)
    seed = 19 + L
    assert ta.dropattn_bwd_route(torch.bfloat16, 16, L) == "tc"
    _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
    before = (ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.three_pass_launches,
              ta.dropattn_bwd.stream_launches)
    grads = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    assert (ta.dropattn_bwd.tc_launches, ta.dropattn_bwd.three_pass_launches,
            ta.dropattn_bwd.stream_launches) == (before[0] + 1, before[1] + 1, before[2])
    again = ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, grads, want)
    for name, a, b, bd in zip("dq dk dv".split(), grads, want, bounds):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= bd).all()), (name, (diff / bd).max().item())


@pytest.mark.parametrize("d", [32, 64])
def test_three_pass_kernel_stays_off_the_other_head_dims(d):
    """bf16 at head dims 32 and 64 keeps dropattn_bwd_tc_kernel: its
    launches do not count in three_pass_launches; the three-pass kernel at
    those head dims, reached through its probe entry, is still within the
    bound of the plain pair."""
    _need_card()
    q, k, v, go, bias = _attn_inputs(4, 4, 64, d, torch.bfloat16, seed=800 + d)
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 3)
    before = ta.dropattn_bwd.three_pass_launches
    ta.dropattn_bwd(q, k, v, bias, 0.1, 3, lse, go)
    assert ta.dropattn_bwd.three_pass_launches == before
    got = ta.dropattn_bwd_tc_kernel(1, q, k, v, bias, 0.1, 3, lse, go)
    want = ta.dropattn_bwd_plain(q, k, v, bias, 0.1, 3, lse, go)
    torch.cuda.synchronize()
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, 0.1, 3, lse, go, got, want)
    for a, b, bd in zip(got, want, bounds):
        assert bool(((a.float() - b.float()).abs() <= bd).all())


@pytest.mark.parametrize("kw", [
    dict(index_type="exact"), dict(index_type="approx"),
    dict(index_type="clustered", cluster_rows=1024, nprobe=8),
    dict(index_type="approx", refine_m=40),
], ids=["exact", "approx", "clustered", "refine"])
def test_one_device_cuda_mesh_gives_the_single_device_ids(kw):
    """A ShardedIndex over a one-device CUDA mesh (each engine's kernels,
    launched under the shard's device guard) against the single-device
    engine on the same int8 rows, and over two shards of the one card
    against the exact engine."""
    _need_card()
    import numpy as np

    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.parallel.mesh import create_mesh

    rng = np.random.default_rng(31)
    x = rng.standard_normal((60_000, 128)).astype(np.float32)
    q = x[:64] + 0.05 * rng.standard_normal((64, 128)).astype(np.float32)
    ids = [str(i) for i in range(len(x))]
    single = IndexBuilder(128, dtype="int8", device="cuda", **kw).build_from_arrays(x, ids)
    meshes = [create_mesh(1, 1)]
    if kw["index_type"] == "exact":  # the merge of two shards is exact only for exact
        meshes.append(create_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2))
    for mesh in meshes:
        sharded = ShardedIndex.from_builder(single, mesh)
        for B in (1, 16, 64):
            want_v, want = single.search(q[:B], k=10)
            got_v, got = sharded.search(q[:B], k=10)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
