"""Attention for the encoder (port of sskd_tpu/ops/attention.py, its
inference paths).

- :func:`plain_attention` mirrors ``xla_attention``: f32 scores, additive
  bias, softmax, probabilities cast to the value type, f32 accumulation.
- :func:`flash_attention` is the wrapper of the ``flash_attn_fwd`` kernel
  (csrc/flash_attn.cu): on a CUDA tensor it launches the kernel and counts
  the launch in ``flash_attention.launches``; on a CPU tensor it runs
  :func:`flash_attention_plain`, which repeats the kernel's arithmetic.
- :func:`scaled_dot_attention` dispatches: the kernel for ``L >=
  FLASH_MIN_L``, plain attention below.

The TPU's dispatch rule (a 256 MB score threshold, head groups sized to
VMEM) is not carried over. ``FLASH_MIN_L`` = 512 is the length the corpus
encode runs at; where the kernel starts to beat plain attention on the H100
is measured by chip_smoke.py at L = 128, 256 and 512.

The fused dropout-attention kernels of training and the flash backward are
a later slice of the port.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sskd_tpu_torch.ops import _build

NEG_INF = float(torch.finfo(torch.float32).min) / 2
FLASH_MIN_L = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def plain_attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v for q, k, v [B, h, L, d]; ``bias``
    broadcastable to [B, h, L, L] (additive)."""
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def flash_attention_plain(q, k, v, mask=None):
    """Plain torch version of the kernel: masked keys score
    ``finfo(f32).min / 2``, p = exp(s - max) is summed in f32 and rounded to
    the input type before the p.v product, the sum divides at the end."""
    B, h, L, d = q.shape
    sm_scale = 1.0 / (d**0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = torch.where(mask[:, None, None, :] != 0, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / denom
    return out.to(q.dtype)


def flash_error_bound(q, k, v, mask, got, want):
    """Per-element bound on |got - want| between two bf16 results of this
    arithmetic that differ only in f32 summation order (the kernel and
    :func:`flash_attention_plain`). Each side rounds each p to bf16 (relative
    error at most 2^-8), so the numerators differ by at most
    2^-7 * sum(p |v|); over the shared f32 sum of p that is 2^-7 times
    softmax(s) @ |v|. Each side then rounds its output once more (2^-8 of its
    value). The f32 reordering adds 1e-5 of the same weighted |v|."""
    weighted_abs_v = flash_attention_plain(q.float(), k.float(), v.float().abs(), mask)
    return (
        2.0**-8 * (got.float().abs() + want.float().abs())
        + (2.0**-7 + 1e-5) * weighted_abs_v
        + 1e-6
    )


def flash_attention(q, k, v, mask=None):
    """Attention of q, k, v [B, h, L, d] (bf16 or f32) with a key keep-mask
    ``mask`` [B, L] (nonzero = attend; None = all), without an [L, L] score
    matrix in device memory. Returns [B, h, L, d] in the input type."""
    B, h, L, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape [B, h, L, d]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if mask is not None and mask.shape != (B, L):
        raise ValueError(f"mask must be [B, L] = [{B}, {L}]")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd supports head dims {_HEAD_DIMS}, got {d}")
    mask = (
        torch.ones((B, L), dtype=torch.int32, device=q.device)
        if mask is None
        else mask.to(torch.int32)
    )
    q, k, v, mask = (t.contiguous() for t in (q, k, v, mask))
    for t in (k, v, mask):
        if t.device != q.device:
            raise ValueError("q, k, v and mask must be on one device")
    out = torch.empty_like(q)
    lib = _build.load_library("flash_attn")
    fn = lib.sskd_flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float,
        ctypes.c_void_p,
    ]
    _build.check(
        fn(
            _DTYPES[q.dtype],
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, mask, out)),
            B, h, L, d, 1.0 / (d**0.5),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        ),
        "flash_attn_fwd",
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def scaled_dot_attention(q, k, v, bias=None):
    """Dispatching attention. ``bias``: the encoder's additive mask
    [B, 1, 1, L]; the flash path turns it back into a keep-mask
    (``bias >= -1``, as the JAX dispatcher does)."""
    L = q.shape[2]
    if L >= FLASH_MIN_L:
        mask = None if bias is None else (bias[:, 0, 0, :] >= -1.0).to(torch.int32)
        return flash_attention(q, k, v, mask)
    return plain_attention(q, k, v, bias)
