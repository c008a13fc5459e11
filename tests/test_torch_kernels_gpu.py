"""The three CUDA kernels against their plain torch versions, on the card.

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


def test_launch_counters_count_kernel_launches_only():
    from sskd_tpu_torch.ops import launch_counts, reset_launch_counts

    _need_card()
    reset_launch_counts()
    x, q = _data(1000, 64, 2, seed=0)
    tk.binmax(q, x)
    tk.binmax_plain(q, x)
    assert launch_counts()["binmax"] == 1
