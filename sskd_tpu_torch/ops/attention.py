"""Attention for the encoder (port of sskd_tpu/ops/attention.py).

- :func:`plain_attention` mirrors ``xla_attention``: f32 scores, additive
  bias, softmax, probabilities cast to the value type, f32 accumulation.
- :func:`flash_attention` is the wrapper of the ``flash_attn_fwd`` kernel
  (csrc/flash_attn.cu): on a CUDA tensor it launches the kernel and counts
  the launch in ``flash_attention.launches`` (and, on the tensor-core route
  of :func:`flash_route`, in ``flash_attention.tc_launches``); on a CPU
  tensor it runs :func:`flash_attention_plain`, which repeats the kernel's
  arithmetic.
- :func:`scaled_dot_attention` dispatches: the kernel for ``L >=
  FLASH_MIN_L``, plain attention below. The flash branch is differentiable:
  its backward is the VJP of :func:`plain_attention` with the same bias, as
  ``_flash_attention_diff`` does in the JAX package.
- :func:`dropout_attention` is training attention with dropout on the
  probabilities, over the ``dropattn_fwd`` / ``dropattn_bwd`` kernels
  (csrc/dropattn_fwd.cu, csrc/dropattn_bwd.cu), the port of the Pallas pair
  ``_dropattn_fwd_kernel`` / ``_dropattn_bwd_kernel``, at head dims 16 (the
  pipeline's ``--tiny`` models), 32 (the student's) and 64 (the teacher's).
  The forward is on the tensor cores for bf16 at head dims 16, 32 and 64
  while the head fits a block and for f32 at every head dim and L
  (:func:`dropattn_fwd_route`), as flash is for every (dtype, head dim)
  (:func:`flash_route`); the backward is on the tensor cores at
  every (dtype, head dim, L) it takes, a head held in shared memory
  (``"tc"``; for bf16 at head dim 16 without an [L, L] buffer, in three
  passes) or streamed through it (``"tc_stream"``,
  :func:`dropattn_bwd_route`). ``tc_launches`` counts the tensor-core
  launches, ``dropattn_bwd.stream_launches`` the streaming ones and
  ``dropattn_bwd.three_pass_launches`` the three-pass ones.
- The f32 tensor-core routes (every f32 attention of the port: the
  teacher's, the f32 student's training and its encode) take each product
  as three TF32 products on the tensor cores (hi and lo terms of each
  operand, f32 sums: csrc/mma_common.cuh), which keeps the f32 function to
  about 2^-21 of each product; one TF32 pass would be ~1e-3 off. One
  template of each forward serves head dims 16, 32 and 64; no f32
  attention runs on the CUDA cores.

The three wrappers also count their launches by head dim
(``head_dim_launches``, ``{d: launches}``).

The TPU's dispatch rule (a 256 MB score threshold, head groups sized to
VMEM) is not carried over. ``FLASH_MIN_L`` = 512 is the length the corpus
encode runs at.

The dropout keep-mask. The TPU kernels draw it from the TPU's own generator,
which nothing else reproduces. Here it is Philox4x32-10 keyed by ``(seed,
b*h)`` with the counter ``(col // 4, row, 0, 0)``; element ``(row, col)``
takes word ``col % 4`` of the output, and is kept when the top 24 bits of
that word, over 2^24, are ``>= p`` (the rule of ``_uniform_bits``). The mask
is thus a pure function of ``(seed, b*h, row, col)``: the forward, the
backward and a recompute of the forward under checkpointing all see the same
one, whatever the tiling. :func:`dropout_keep_mask` computes the same bits
in plain torch on int64 tensors, building each 32 x 32 -> 64-bit product
from 16-bit halves so nothing overflows.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sskd_tpu_torch.ops import _build

NEG_INF = float(torch.finfo(torch.float32).min) / 2
FLASH_MIN_L = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
# the dropattn kernels are built for the head dims of the models the port
# trains (e5-small-v2: 384 / 12; bge-reranker-large: 1024 / 16; the
# pipeline's --tiny BertConfig: 64 / 4) and refuse others
_DROPATTN_HEAD_DIMS = (16, 32, 64)
_SMEM_MAX = 227 * 1024  # shared memory a block may hold (DT_SMEM_MAX, DF_SMEM_MAX)


# the (dtype, head dim) whose resident backward is dropattn_bwd_tc_3pass_kernel
# (no [Lp, Lp] buffer: dv and dk from registers, a third pass over the keys);
# the others keep dropattn_bwd_tc_kernel / dropattn_bwd_tc_tf32_kernel. On an
# H100 (tools/probe_dropattn16.py) the three passes took [256, 4, 192, 16] p 0.1
# from 0.170 to 0.157 ms and lost at head dims 32 (0.574 against 0.545) and 64
DROPATTN_BWD_THREE_PASS = ((torch.bfloat16, 16),)


def _dt_smem_bytes(dtype, d: int, Lp: int) -> int:
    """Shared memory of one block of the resident tensor-core backward with
    one head buffer at padded length ``Lp`` (csrc/dropattn_bwd.cu
    dt_smem_bytes: the head's q, k, v, g rows, bias and lse, the [Lp, Lp]
    buffer of pd then ds, the keep bits, the bias and lse as used; for the
    three-pass kernel dt3_smem_bytes: no buffer, each row's D)."""
    if dtype == torch.bfloat16:
        head, elt = 4 * Lp * (d + 8) * 2 + 2 * Lp * 4, 2
    else:
        head, elt = Lp * (2 * (d + 8) + 2 * (d + 4)) * 4 + 2 * Lp * 4, 4
    if (dtype, d) in DROPATTN_BWD_THREE_PASS:
        return head + Lp * (Lp // 16) * 2 + 3 * Lp * 4
    return head + Lp * (Lp + 8) * elt + Lp * (Lp // 16) * 2 + 2 * Lp * 4


def _dft_smem_bytes(d: int, L: int) -> int:
    """Shared memory of one block of the bf16 tensor-core forward at length
    ``L`` (csrc/dropattn_fwd.cu dft_smem_bytes with dft_warps' rows)."""
    Lp = (L + 15) // 16 * 16
    rows = 16 * (8 if d == 32 else 4 if L <= 64 else 8 if d == 16 else 16)
    return (rows + 2 * Lp) * (d + 8) * 2 + Lp * 4


def _longest(fits) -> int:
    """The largest multiple of 16 for which ``fits`` holds (it holds at 16
    and, once false, stays false)."""
    L = 16
    while fits(L + 16):
        L += 16
    return L


# the longest L whose head fits one block of the resident tensor-core
# backward, by (dtype, head dim): its shared memory with one head buffer
# within _SMEM_MAX and its 2 Lp threads within the kernel's launch bound
# (512 in bf16, 256 in f32); the kernel refuses longer L
DROPATTN_TC_MAX_L = {
    (dtype, d): _longest(lambda L, dt=dtype, d=d: _dt_smem_bytes(dt, d, L) <= _SMEM_MAX
                         and 2 * L <= (512 if dt == torch.bfloat16 else 256))
    for dtype, d in ((torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 64),
                     (torch.float32, 64))
}
# the longest L whose head's K and V fit the shared memory of one block of
# the bf16 tensor-core forward, by (dtype, head dim) (the kernel refuses
# longer L); the f32 tensor-core forwards stream K and V and take any L
DROPATTN_FWD_TC_MAX_L = {
    (torch.bfloat16, d): _longest(lambda L, d=d: _dft_smem_bytes(d, L) <= _SMEM_MAX)
    for d in (16, 32, 64)
}


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of :func:`flash_attention` launches: ``"tc"``
    (tensor cores, csrc/flash_attn.cu) for every (dtype, head dim) it takes:
    ``flash_fwd_tc_kernel`` for bf16 at head dim 32,
    ``flash_fwd_tc2_kernel<D, MT, MINB>`` for bf16 at head dims 16 and 64,
    ``flash_fwd_tc_tf32_kernel<D>`` for f32 at head dims 16, 32 and 64
    (three TF32 products a product). No flash runs on the CUDA cores.

    At the f32 encode shape [256, 12, 512, 32] the bytes take 0.240 ms at
    3.35 TB/s and the three TF32 passes 0.625 ms at TF32's 495 TFLOP/s (the
    same work on the CUDA cores' FMA: 1.538 ms). Of six schedules with the
    same bits (tools/probe_attention_f32.py) the head-dim-64 kernel's 4
    warps, each splitting the K and V values it reads into TF32 terms, came
    first; splitting each tile once for the block doubled its shared memory
    and cost 13-45 %. In bf16 at head dim 16 (the tiny models' encode at
    [256, 4, 512, 16]) one ex2 a score is the floor, 0.064 ms on an H100,
    above the bytes' 0.020 and the products' 0.017; tools/probe_flash16.py
    chose the schedule."""
    return "tc"


def dropattn_fwd_route(dtype: torch.dtype, d: int, L: int) -> str:
    """The kernel a CUDA call of :func:`dropattn_fwd` launches: ``"tc"``
    (tensor cores, csrc/dropattn_fwd.cu: ``dropattn_fwd_tc_kernel`` for bf16
    at head dims 16, 32 and 64 up to ``DROPATTN_FWD_TC_MAX_L[(dtype, d)]``;
    ``dropattn_fwd_tc_tf32_kernel<D>`` for f32 at head dims 16, 32 and 64
    at every L, three TF32 products a product in one online pass over K and
    V tiles of 64 keys), ``"cuda_core"`` (``dropattn_fwd_kernel``) for bf16
    past its limit only.

    At the f32 student's shape [256, 12, 192, 32], p 0.1, the bytes take
    0.090 ms at 3.35 TB/s and the three TF32 passes 0.088 ms; the keep-mask's
    28.3 M Philox calls sit above both (0.231 ms measured as what dropout
    adds to the backward, which draws the same bits). At the tiny teacher's
    [32, 4, 64, 16] the bytes bound it: 0.0006 ms. The head-dim-64 kernel's
    schedule came first at these head dims as it did for flash
    (tools/probe_attention_f32.py)."""
    if dtype == torch.float32:
        return "tc"
    return "tc" if L <= DROPATTN_FWD_TC_MAX_L.get((dtype, d), 0) else "cuda_core"


def dropattn_bwd_route(dtype: torch.dtype, d: int, L: int) -> str:
    """The kernels a CUDA call of :func:`dropattn_bwd` launches: ``"tc"``
    (one tensor-core kernel holding a whole head in shared memory:
    ``dropattn_bwd_tc_3pass_kernel`` for bf16 at head dim 16
    (``DROPATTN_BWD_THREE_PASS``: dv and dk from registers in a third pass
    over the keys, counted in ``three_pass_launches``),
    ``dropattn_bwd_tc_kernel`` for bf16 at head dims 32 and 64,
    ``dropattn_bwd_tc_tf32_kernel`` for f32 at head dim 64) for L up to
    ``DROPATTN_TC_MAX_L[(dtype, d)]``; ``"tc_stream"`` (three tensor-core
    kernels streaming the head through shared memory in 64-row tiles:
    ``dropattn_bwd_stream_rows_kernel`` for D and the keep bits, again for
    dq, then ``dropattn_bwd_stream_cols_kernel`` for dk and dv) for every
    other (dtype, d, L), f32 at head dims 16 and 32 at every L included."""
    return "tc" if L <= DROPATTN_TC_MAX_L.get((dtype, d), 0) else "tc_stream"


def _count(wrapper, d: int, tc: bool) -> None:
    """One launch of ``wrapper``'s kernel at head dim ``d``, on its
    tensor-core route when ``tc``."""
    wrapper.launches += 1
    wrapper.tc_launches += int(tc)
    wrapper.head_dim_launches[d] = wrapper.head_dim_launches.get(d, 0) + 1


def _scale_log2(d: int) -> float:
    """log2(e) / sqrt(d): the tensor-core kernels fold the softmax scale into
    their exponent (one ex2 per score); ctypes rounds it to f32."""
    return math.log2(math.e) / math.sqrt(d)


def _stream(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device, without the Stream object ``torch.cuda.current_stream`` builds;
    raises unless that device is the current one, where the C entry launches."""
    _build.check_current_device(t.device)
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


_CTYPES = {"i": ctypes.c_int, "u": ctypes.c_uint32, "f": ctypes.c_float, "p": ctypes.c_void_p}


@functools.lru_cache(maxsize=None)
def _fn(stem: str, name: str, argtypes: str):
    """C entry point ``name`` of the library built from ``csrc/<stem>.cu``,
    its signature declared once (``argtypes``: one letter an argument)."""
    fn = getattr(_build.load_library(stem), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[c] for c in argtypes.split()]
    return fn


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


def _gamma(depth: int) -> float:
    """Relative error, in units of the sum of the absolute products, that a
    product of ``depth`` terms picks up on the two sides of a comparison: the
    tensor cores (mma.sync m16n8k16, bf16 operands) add each step's 16 exact
    products and the f32 accumulator by aligning them to the largest and
    truncating, not rounding, which loses less than 2^-23 of the largest term
    per term, so at most 17 * 2^-23 of the sum per 16-deep step; an f32 sum
    of ``depth`` terms rounded at each add (the plain version) at most
    ``depth`` * 2^-24."""
    return math.ceil(depth / 16) * 17 * 2.0**-23 + depth * 2.0**-24


def _exponent_error(s, absdot, shift, d: int):
    """Bound on |e| where the tensor-core kernels' probability is the plain
    version's times exp(e), for f32 scores ``s`` (natural units), the sums
    ``absdot`` = |q| @ |k|^T of the same entries and ``shift`` the terms
    subtracted in the exponent (|row max| or |bias| + |lse|). The kernels
    fold scale * log2(e) into the scores and take one ex2: the score's
    products add _gamma(d) of absdot; the two f32 roundings of the folded
    scale and of s * it, and the rounding of the difference, at most 2^-22
    of (|s| + shift); ex2.approx and the plain exp together at most 2^-21."""
    return _gamma(d) * absdot / math.sqrt(d) + 2.0**-22 * (s.abs() + shift) + 2.0**-21


def flash_error_bound(q, k, v, mask, got, want):
    """Per-element bound on |got - want| between two bf16 results of this
    arithmetic: the kernel and :func:`flash_attention_plain`.

    - Each side rounds each p to bf16 (relative error at most 2^-8), so the
      numerators differ by at most 2^-7 * sum(p |v|); over the shared f32 sum
      of p that is 2^-7 times softmax(s) @ |v| (``wv``). Each side then rounds
      its output once more (2^-8 of its value).
    - The tensor-core route computes each p as the plain one times exp(e_j),
      |e_j| <= eps_j (:func:`_exponent_error`; 0 for a masked key, whose
      sentinel score gives both sides exactly 0, or exactly 1 in a row with
      no live key). Over out = N / D that moves out by at most
      1.01 (P @ (eps |v|) + sum(P eps) wv), P the softmax.
    - The sums: p.v on the tensor cores and in f32 (_gamma(L) of wv), the
      online rescaling of the accumulator once per 64-key tile and the f32
      sums of p on both sides (2^-24 each of wv per add)."""
    B, h, L, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (t.float().reshape(B * h, L, d) for t in (q, k, v))
    keep = (torch.ones((B * h, 1, L), dtype=torch.bool, device=q.device) if mask is None
            else (mask != 0).repeat_interleave(h, dim=0)[:, None, :])
    wv, drift = torch.empty_like(qf), torch.empty_like(qf)
    for a, b in _chunks(B * h, L):
        s = torch.matmul(qf[a:b], kf[a:b].transpose(-1, -2)) * scale
        live = keep[a:b]
        P = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
        m = torch.where(live, s, -math.inf).amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        absdot = torch.matmul(qf[a:b].abs(), kf[a:b].abs().transpose(-1, -2))
        eps = torch.where(live, _exponent_error(s, absdot, m.abs(), d), 0.0)
        absv = vf[a:b].abs()
        wv[a:b] = torch.matmul(P, absv)
        Pe = P * eps
        drift[a:b] = 1.01 * (torch.matmul(Pe, absv) + Pe.sum(dim=-1, keepdim=True) * wv[a:b])
    sums = _gamma(L) + (math.ceil(L / 64) + L) * 2.0**-24
    return (
        2.0**-8 * (got.float().abs() + want.float().abs())
        + (2.0**-7 + sums) * wv.view(B, h, L, d)
        + drift.view(B, h, L, d)
        + 1e-6
    )


def flash_attention(q, k, v, mask=None):
    """Attention of q, k, v [B, h, L, d] (bf16 or f32) with a key keep-mask
    ``mask`` [B, L] (nonzero = attend; None = all), without an [L, L] score
    matrix in device memory. Returns [B, h, L, d] in the input type. The
    kernel's output carries no gradient: :func:`scaled_dot_attention` is the
    differentiable entry."""
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
    fn = _fn("flash_attn", "sskd_flash_attn_fwd_tc", "i p p p p p i i i i f f p")
    _build.check(
        fn(_DTYPES[q.dtype], *(_ptr(t) for t in (q, k, v, mask, out)), B, h, L, d,
           1.0 / (d**0.5), _scale_log2(d), _stream(q)),
        "flash_attn_fwd (tensor cores)",
    )
    _count(flash_attention, d, tc=True)
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0  # the launches that took the tensor-core route
flash_attention.head_dim_launches = {}


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward; the backward is the VJP of
    :func:`plain_attention` with the additive bias (one [B, h, L, L]
    recompute in the backward only), as ``_flash_diff_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias):
        ctx.save_for_backward(q, k, v, bias)
        return flash_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = plain_attention(*leaves, bias)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def scaled_dot_attention(q, k, v, bias=None):
    """Dispatching attention. ``bias``: the encoder's additive mask
    [B, 1, 1, L]; the flash path turns it back into a keep-mask
    (``bias >= -1``, as the JAX dispatcher does)."""
    B, _, L, _ = q.shape
    if L >= FLASH_MIN_L:
        if bias is None:
            mask = None
            bias = torch.zeros((B, 1, 1, L), dtype=torch.float32, device=q.device)
        else:
            bias = bias.detach()
            mask = (bias[:, 0, 0, :] >= -1.0).to(torch.int32)
        return _FlashAttention.apply(q, k, v, mask, bias)
    return plain_attention(q, k, v, bias)


# ---------------------------------------------------------------------------
# Dropout attention: the keep-mask generator
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for int64 ``a`` in [0, 2^32) and a
    32-bit constant ``m``, from 16-bit halves so no product passes 2^34."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = a_hi * m_hi + (mid >> 16)
    return hi, lo


def philox4x32(c0, c1, k0: int, k1: torch.Tensor, c2=0, c3=0) -> list[torch.Tensor]:
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1),
    on int64 tensors holding uint32 values (Random123's round and key
    schedule; csrc/philox.cuh is the same function with c2 = c3 = 0)."""
    c0, c1, k1 = torch.broadcast_tensors(c0, c1, k1)
    c2 = torch.full_like(c0, c2)
    c3 = torch.full_like(c0, c3)
    k0 = torch.full_like(c0, k0 & _U32)
    k1 = k1.clone()
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _U32
            k1 = (k1 + _PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def dropout_uniform(seed: int, bh0: int, n_bh: int, L: int, device=None) -> torch.Tensor:
    """The uniforms [n_bh, L, L] (f32, multiples of 2^-24 in [0, 1)) of
    heads ``bh0 .. bh0 + n_bh - 1``; element (row, col) of head ``bh`` is
    word ``col % 4`` of Philox(counter (col // 4, row), key (seed, bh))."""
    L4 = (L + 3) // 4
    bh = torch.arange(bh0, bh0 + n_bh, dtype=torch.int64, device=device)[:, None, None]
    row = torch.arange(L, dtype=torch.int64, device=device)[None, :, None]
    col4 = torch.arange(L4, dtype=torch.int64, device=device)[None, None, :]
    words = philox4x32(col4, row, int(seed), bh)
    bits = torch.stack(words, dim=-1).reshape(n_bh, L, 4 * L4)[:, :, :L]
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def dropout_keep_mask(seed: int, BH: int, L: int, p: float, device=None) -> torch.Tensor:
    """The keep-mask [BH, L, L] (bool) the kernels apply at rate ``p``."""
    return dropout_uniform(seed, 0, BH, L, device) >= p


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """A keep-mask [n, L, L] (bool) packed as the streaming backward's first
    kernel writes it: int32 words [n, L, ceil(L / 32)] (uint32 bit
    patterns), bit j % 32 of word j // 32 holding key j's bit, bits past L
    0."""
    n, L, _ = keep.shape
    W = (L + 31) // 32
    bits = torch.nn.functional.pad(keep, (0, 32 * W - L)).view(n, L, W, 32).to(torch.int64)
    words = (bits << torch.arange(32, dtype=torch.int64, device=keep.device)).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def dropout_keep_bits(seed: int, BH: int, L: int, p: float, device=None) -> torch.Tensor:
    """The keep-mask of :func:`dropout_keep_mask` packed by
    :func:`pack_keep_bits`: [BH, L, ceil(L / 32)] int32."""
    return torch.cat([pack_keep_bits(dropout_uniform(seed, a, b - a, L, device) >= p)
                      for a, b in _chunks(BH, L)])


# ---------------------------------------------------------------------------
# Dropout attention: plain versions and the error bounds
# ---------------------------------------------------------------------------

def _chunks(BH: int, L: int):
    """Head ranges for the plain versions: each [chunk, L, L] temporary
    holds at most 2^27 elements (512 MB in f32) at any L."""
    step = max(1, (1 << 27) // (L * L))
    for start in range(0, BH, step):
        yield start, min(BH, start + step)


def _probs_and_mask(qc, kc, biasc, p, seed, bh0, scale, lse=None):
    """f32 scores -> probs (softmax, or exp(s - lse) when ``lse`` is given)
    and the keep-mask of heads ``bh0 ..`` (None at p = 0)."""
    s = torch.matmul(qc.float(), kc.float().transpose(-1, -2)) * scale + biasc[:, None, :]
    if lse is None:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        total = e.sum(dim=-1, keepdim=True)
        probs = e / total
        lse = (m + torch.log(total))[..., 0]
    else:
        probs = torch.exp(s - lse[..., None])
    keep = None
    if p > 0.0:
        keep = dropout_uniform(seed, bh0, qc.shape[0], qc.shape[1], qc.device) >= p
    return probs, keep, lse


def _flat(q, k, v, bias):
    B, h, L, d = q.shape
    heads_bias = bias.float().repeat_interleave(h, dim=0)  # [B*h, L]
    return (q.reshape(B * h, L, d), k.reshape(B * h, L, d), v.reshape(B * h, L, d),
            heads_bias)


def dropattn_fwd_plain(q, k, v, bias, p: float, seed: int):
    """Plain torch version of ``dropattn_fwd``: scores in f32 from the input
    type, softmax in f32, kept probabilities times 1 / (1 - p), rounded to
    v's type before the product with v (f32 sums). Returns (out [B, h, L, d]
    in the input type, lse [B, h, L] f32: the log-sum-exp of each score row,
    saved for the backward)."""
    B, h, L, d = q.shape
    qf, kf, vf, bf = _flat(q, k, v, bias)
    out = torch.empty_like(qf)
    lse = torch.empty((B * h, L), dtype=torch.float32, device=q.device)
    inv = 1.0 / (1.0 - p)
    for a, b in _chunks(B * h, L):
        probs, keep, lse[a:b] = _probs_and_mask(qf[a:b], kf[a:b], bf[a:b], p, seed, a,
                                                1.0 / (d**0.5))
        pd = probs if keep is None else torch.where(keep, probs * inv, 0.0)
        out[a:b] = torch.matmul(pd.to(v.dtype).float(), vf[a:b].float()).to(v.dtype)
    return out.view(B, h, L, d), lse.view(B, h, L)


def dropattn_bwd_plain(q, k, v, bias, p: float, seed: int, lse, g):
    """Plain torch version of ``dropattn_bwd``: probs = exp(s - lse), the
    same keep-mask, ``dv = pd^T g``, ``dprobs = mask(g v^T) / (1 - p)``,
    ``ds = probs (dprobs - <dprobs, probs>) / sqrt(d)``, ``dq = ds k``,
    ``dk = ds^T q``; pd and ds are rounded to the input type before their
    products, as the TPU kernel does; results in the input type."""
    B, h, L, d = q.shape
    qf, kf, vf, bf = _flat(q, k, v, bias)
    gf = g.reshape(B * h, L, d)
    lsef = lse.reshape(B * h, L)
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    inv = 1.0 / (1.0 - p)
    scale = 1.0 / (d**0.5)
    cdt = q.dtype
    for a, b in _chunks(B * h, L):
        probs, keep, _ = _probs_and_mask(qf[a:b], kf[a:b], bf[a:b], p, seed, a, scale,
                                         lsef[a:b])
        gc = gf[a:b].float()
        dpd = torch.matmul(gc, vf[a:b].float().transpose(-1, -2))
        if keep is None:
            pd, dprobs = probs, dpd
        else:
            pd = torch.where(keep, probs * inv, 0.0)
            dprobs = torch.where(keep, dpd * inv, 0.0)
        dv[a:b] = torch.matmul(pd.to(cdt).float().transpose(-1, -2), gc).to(cdt)
        ds = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True)) * scale
        ds = ds.to(cdt).float()
        dq[a:b] = torch.matmul(ds, kf[a:b].float()).to(cdt)
        dk[a:b] = torch.matmul(ds.transpose(-1, -2), qf[a:b].float()).to(cdt)
    return dq.view(B, h, L, d), dk.view(B, h, L, d), dv.view(B, h, L, d)


def dropout_attention_plain(q, k, v, bias, p: float, seed: int):
    """Forward of dropout attention in plain torch, differentiable by
    autograd through its ops (the mask is a constant of the graph)."""
    B, h, L, d = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    probs = torch.softmax(s + bias.float()[:, None, None, :], dim=-1)
    if p > 0.0:
        keep = dropout_keep_mask(seed, B * h, L, p, q.device).view(B, h, L, L)
        probs = torch.where(keep, probs * (1.0 / (1.0 - p)), 0.0)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def _abs_products(q, k, v, bias, p, seed, lse, g):
    """f32 sums of absolute values that bound each backward product's
    error, over every head: ``pg`` = pd^T @ |g|, ``dsk`` = |ds| @ |k|,
    ``dsq`` = |ds|^T @ |q| and the drift of the tensor-core arithmetic (see
    :func:`dropattn_bwd_error_bound`):
    ``pg_drift`` = (eps pd)^T @ |g|, ``dsk_drift`` = delta_ds @ |k| and
    ``dsq_drift`` = delta_ds^T @ |q|."""
    B, h, L, d = q.shape
    qf, kf, vf, bf = (t.float() for t in _flat(q, k, v, bias))
    gf = g.reshape(B * h, L, d).float()
    inv, scale = 1.0 / (1.0 - p), 1.0 / (d**0.5)
    names = ("pg", "dsk", "dsq", "pg_drift", "dsk_drift", "dsq_drift")
    out = {n: torch.empty_like(qf) for n in names}
    for a, b in _chunks(B * h, L):
        lse_c = lse.reshape(B * h, L)[a:b].float()
        probs, keep, _ = _probs_and_mask(qf[a:b], kf[a:b], bf[a:b], p, seed, a, scale, lse_c)
        pd = probs if keep is None else torch.where(keep, probs * inv, 0.0)
        gc, qa, ka, va = gf[a:b], qf[a:b].abs(), kf[a:b].abs(), vf[a:b].abs()
        out["pg"][a:b] = torch.matmul(pd.transpose(-1, -2), gc.abs())
        dpd = torch.matmul(gc, vf[a:b].transpose(-1, -2))
        dprobs = dpd * inv if keep is None else torch.where(keep, dpd * inv, 0.0)
        D = (dprobs * probs).sum(dim=-1, keepdim=True)
        ds = probs * (dprobs - D) * scale
        out["dsk"][a:b] = torch.matmul(ds.abs(), ka)
        out["dsq"][a:b] = torch.matmul(ds.abs().transpose(-1, -2), qa)
        # the exponent's error where probs > 0 (a padded key's probs is 0 on
        # both sides), the score product's and dP's
        s = torch.matmul(qf[a:b], kf[a:b].transpose(-1, -2)) * scale
        shift = bf[a:b].abs()[:, None, :] + lse_c.abs()[:, :, None]
        eps = 1.01 * _exponent_error(s, torch.matmul(qa, ka.transpose(-1, -2)), shift, d)
        eps = torch.where(probs > 0, eps, 0.0)
        d_dprobs = inv * _gamma(d) * torch.matmul(gc.abs(), va.transpose(-1, -2))
        pa = probs * dprobs.abs()
        d_D = ((probs * (d_dprobs + eps * dprobs.abs())).sum(dim=-1, keepdim=True) * 1.01
               + L * 2.0**-23 * pa.sum(dim=-1, keepdim=True))
        d_ds = (scale * 1.01 * probs * (eps * (dprobs.abs() + D.abs()) + d_dprobs + d_D)
                + 2.0**-22 * ds.abs())
        out["pg_drift"][a:b] = torch.matmul((eps * pd).transpose(-1, -2), gc.abs())
        out["dsk_drift"][a:b] = torch.matmul(d_ds, ka)
        out["dsq_drift"][a:b] = torch.matmul(d_ds.transpose(-1, -2), qa)
    return {n: t.view(B, h, L, d) for n, t in out.items()}


# relative error of one rounding to the input type: bf16 keeps 8 bits, so
# round-to-nearest is off by at most 2^-8 of the value; f32 2^-24
def _unit(dtype) -> float:
    return 2.0**-8 if dtype == torch.bfloat16 else 2.0**-24


def dropattn_fwd_error_bound(q, k, v, bias, p, seed, got, want):
    """Per-element bound on |got - want| between a bf16 forward kernel (the
    tensor-core route at head dims 16, 32 and 64, or the CUDA-core one) and
    :func:`dropattn_fwd_plain` on the same inputs and the same mask.

    - Both round each kept probability to the input type (at most u of it,
      u = 2^-8 in bf16), so the products with v differ by at most 2u of
      ``pv`` = pd @ |v|; each side rounds its output (u of its value).
    - The tensor-core route takes each normalised probability as one exp2 of
      the score folded with scale * log2(e) and of (bias - lse) * log2(e), so
      its probs are the plain ones times exp(e_j), |e_j| <= eps_j + d_lse:
      eps_j (:func:`_exponent_error` with |bias| + |lse| as the shift, 0 where
      probs is 0) for the score's truncating sums and the roundings, and
      d_lse for its own lse: the largest eps_j of the row, which moves each
      term of the row's sum as much, the ex2 of each rescale of the running
      sums (one per 16-key chunk and per merge, 2^-21 each), the f32 sums of
      L terms (L * 2^-24) and log2 (2^-21). Through pd @ v that moves out by
      at most 1.01 (pd @ (eps |v|) + d_lse pv).
    - The products over L: _gamma(L) of pv (truncating mma sums on one side,
      f32 sums on the other). The CUDA-core route (online max and sum,
      expf and a division) moves each probability by less than the 1e-5
      (pd @ |v|) term, which the bound keeps. The f32 routes are held to
      1e-5 instead."""
    u = _unit(q.dtype)
    B, h, L, d = q.shape
    qf, kf, vf, bf = (t.float() for t in _flat(q, k, v, bias))
    inv, scale = 1.0 / (1.0 - p), 1.0 / (d**0.5)
    pv, drift = torch.empty_like(qf), torch.empty_like(qf)
    rescale = (math.ceil(L / 16) + 3) * 2.0**-21 + L * 2.0**-24
    for a, b in _chunks(B * h, L):
        probs, keep, lse = _probs_and_mask(qf[a:b], kf[a:b], bf[a:b], p, seed, a, scale)
        pd = probs if keep is None else torch.where(keep, probs * inv, 0.0)
        absv = vf[a:b].abs()
        pv[a:b] = torch.matmul(pd, absv)
        s = torch.matmul(qf[a:b], kf[a:b].transpose(-1, -2)) * scale
        absdot = torch.matmul(qf[a:b].abs(), kf[a:b].abs().transpose(-1, -2))
        shift = bf[a:b].abs()[:, None, :] + lse.abs()[:, :, None]
        eps = torch.where(probs > 0, _exponent_error(s, absdot, shift, d), 0.0)
        d_lse = eps.amax(dim=-1, keepdim=True) + rescale
        drift[a:b] = 1.01 * (torch.matmul(pd * eps, absv) + d_lse * pv[a:b])
    pv, drift = pv.view(B, h, L, d), drift.view(B, h, L, d)
    return (u * (got.float().abs() + want.float().abs())
            + (2 * u + 1e-5 + (1 + u) * _gamma(L)) * pv + (1 + u) * drift + 1e-6)


def dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, g, got, want):
    """Per-element bounds (dq, dk, dv) on |got - want| between the backward
    kernels (either route) and :func:`dropattn_bwd_plain`.

    - Each side rounds pd (for dv) and ds (for dq, dk) to the input type:
      at most 2u of the sums of absolute products (u = 2^-8 in bf16); each
      output is rounded once more (u of its value).
    - probs: the tensor-core route takes exp2 of the score folded with
      scale * log2(e) and of (bias - lse) * log2(e), so its probs are the
      plain ones times exp(e), |e| <= eps (:func:`_exponent_error` with
      |bias| + |lse| as the shift); dP = g v^T carries _gamma(d) of |g| @
      |v|^T. Through D = sum(dprobs probs) (plus both sides' f32 sums, L *
      2^-23 of sum |dprobs probs|) and ds = probs (dprobs - D) scale (three
      f32 roundings a side), that moves ds by at most delta_ds =
      1.01 scale probs (eps (|dprobs| + |D|) + delta_dprobs + delta_D) +
      2^-22 |ds|; pd moves by eps pd.
    - The products over L: _gamma(L) of the same sums of absolute products.
    The streaming route takes the resident route's arithmetic over other
    tiles (its S^T and dP^T with the operands' roles swapped), which the
    same terms cover. The f32 routes are held to 1e-5 instead."""
    u = _unit(q.dtype)
    t = _abs_products(q, k, v, bias, p, seed, lse, g)
    L = q.shape[2]

    def bound(got_, want_, absprod, drift):
        return (u * (got_.float().abs() + want_.float().abs())
                + (2 * u + (1 + u) * _gamma(L)) * absprod + (1 + u) * drift + 1e-6)

    return (
        bound(got[0], want[0], t["dsk"], t["dsk_drift"]),
        bound(got[1], want[1], t["dsq"], t["dsq_drift"]),
        bound(got[2], want[2], t["pg"], t["pg_drift"]),
    )


# ---------------------------------------------------------------------------
# Dropout attention: the kernel wrappers
# ---------------------------------------------------------------------------


def _check_dropattn(q, k, v, bias, p):
    B, h, L, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape [B, h, L, d]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dropout_attention takes float32 or bfloat16, got {q.dtype}")
    if bias.shape != (B, L):
        raise ValueError(f"bias must be [B, L] = [{B}, {L}]")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dropout_attention runs on cuda or cpu, not {q.device}")
    for t in (k, v, bias):
        if t.device != q.device:
            raise ValueError("q, k, v and bias must be on one device")
    if q.device.type == "cuda" and d not in _DROPATTN_HEAD_DIMS:
        raise ValueError(f"dropattn kernels support head dims {_DROPATTN_HEAD_DIMS}, got {d}; "
                         "any L is taken")


def dropattn_fwd(q, k, v, bias, p: float, seed: int):
    """Wrapper of the ``dropattn_fwd`` kernel: (out, lse) as
    :func:`dropattn_fwd_plain` returns them. ``bias`` [B, L] is added to
    every score of key column j; ``seed`` selects the keep-mask."""
    _check_dropattn(q, k, v, bias, p)
    if q.device.type == "cpu":
        return dropattn_fwd_plain(q, k, v, bias, p, seed)
    B, h, L, d = q.shape
    q, k, v = (t.contiguous() for t in (q, k, v))
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, h, L), dtype=torch.float32, device=q.device)
    if dropattn_fwd_route(q.dtype, d, L) == "tc":
        fn = _fn("dropattn_fwd", "sskd_dropattn_fwd_tc", "i p p p p p p i i i i f f u f f p")
        _build.check(
            fn(_DTYPES[q.dtype], *(_ptr(t) for t in (q, k, v, bias, out, lse)), B, h, L, d,
               1.0 / (d**0.5), _scale_log2(d), int(seed) & _U32, float(p), 1.0 / (1.0 - p),
               _stream(q)),
            "dropattn_fwd (tensor cores)",
        )
        _count(dropattn_fwd, d, True)
        return out, lse
    fn = _fn("dropattn_fwd", "sskd_dropattn_fwd", "i p p p p p p i i i i f u f f p")
    _build.check(
        fn(_DTYPES[q.dtype], *(_ptr(t) for t in (q, k, v, bias, out, lse)), B, h, L, d,
           1.0 / (d**0.5), int(seed) & _U32, float(p), 1.0 / (1.0 - p), _stream(q)),
        "dropattn_fwd",
    )
    _count(dropattn_fwd, d, False)
    return out, lse


dropattn_fwd.launches = 0
dropattn_fwd.tc_launches = 0  # the launches that took the tensor-core route
dropattn_fwd.head_dim_launches = {}


def dropattn_bwd(q, k, v, bias, p: float, seed: int, lse, g):
    """Wrapper of the ``dropattn_bwd`` kernels: (dq, dk, dv) in the input
    type, as :func:`dropattn_bwd_plain` computes them."""
    _check_dropattn(q, k, v, bias, p)
    if g.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("g must be [B, h, L, d] and lse [B, h, L]")
    if q.device.type == "cpu":
        return dropattn_bwd_plain(q, k, v, bias, p, seed, lse, g)
    B, h, L, d = q.shape
    q, k, v = (t.contiguous() for t in (q, k, v))
    g = g.to(q.dtype).contiguous()
    bias = bias.to(torch.float32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    if dropattn_bwd_route(q.dtype, d, L) == "tc_stream":
        return _dropattn_bwd_stream(q, k, v, bias, p, seed, lse, g)[:3]
    # one allocation for the three gradients (each a contiguous view): the
    # wrapper's host time, not the card's, sets the pace of a small launch
    dq, dk, dv = torch.empty((3, *q.shape), dtype=q.dtype, device=q.device).unbind(0)
    fn = _fn("dropattn_bwd", "sskd_dropattn_bwd_tc", _BWD_TC_ARGS)
    _build.check(
        fn(_DTYPES[q.dtype], *(_ptr(t) for t in (q, k, v, bias, g, lse, dq, dk, dv)),
           B, h, L, d,
           1.0 / (d**0.5), _scale_log2(d), int(seed) & _U32, float(p), 1.0 / (1.0 - p),
           _stream(q)),
        "dropattn_bwd (tensor cores)",
    )
    _count(dropattn_bwd, d, True)
    dropattn_bwd.three_pass_launches += (q.dtype, d) in DROPATTN_BWD_THREE_PASS
    return dq, dk, dv


# the arguments of sskd_dropattn_bwd_tc (sskd_dropattn_bwd_tc_kernel takes the
# kernel's number in place of the dtype)
_BWD_TC_ARGS = "i p p p p p p p p p i i i i f f u f f p"


def dropattn_bwd_tc_kernel(kernel: int, q, k, v, bias, p: float, seed: int, lse, g):
    """Either bf16 resident backward kernel on CUDA tensors as
    :func:`dropattn_bwd` prepares them, whatever the route: ``kernel`` 0
    ``dropattn_bwd_tc_kernel`` (the [Lp, Lp] buffer), 1
    ``dropattn_bwd_tc_3pass_kernel``, at head dims 16, 32 and 64 and L up to
    ``DROPATTN_TC_MAX_L[(bf16, d)]``, so that a probe can time them side by
    side. Not a path kernel: it counts no launch. Returns (dq, dk, dv)."""
    B, h, L, d = q.shape
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("dropattn_bwd_tc_kernel takes bf16 CUDA tensors")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = _fn("dropattn_bwd", "sskd_dropattn_bwd_tc_kernel", _BWD_TC_ARGS)
    _build.check(
        fn(int(kernel), *(_ptr(t) for t in (q, k, v, bias, g, lse, dq, dk, dv)), B, h, L, d,
           1.0 / (d**0.5), _scale_log2(d), int(seed) & _U32, float(p), 1.0 / (1.0 - p),
           _stream(q)),
        f"dropattn_bwd kernel {kernel}",
    )
    return dq, dk, dv


def _dropattn_bwd_stream(q, k, v, bias, p: float, seed: int, lse, g):
    """The streaming route's three launches on CUDA tensors as
    :func:`dropattn_bwd` prepares them (contiguous; g in q's type, bias and
    lse f32), at any L: (dq, dk, dv, D [B, h, L] f32, the keep bits [B*h,
    L, ceil(L / 32)] int32 as :func:`pack_keep_bits` lays them out, written
    at p > 0 only). D and the bits are the first kernel's scratch, returned
    for checks. :func:`dropattn_bwd` calls it past the resident route's
    lengths; a check may call it at any length. Counted as one launch on the
    tensor cores and one on the streaming route."""
    B, h, L, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"the streaming dropattn_bwd runs on cuda, not {q.device}")
    if d not in _DROPATTN_HEAD_DIMS:
        raise ValueError(f"dropattn kernels support head dims {_DROPATTN_HEAD_DIMS}, got {d}")
    if (g.dtype != q.dtype or bias.dtype != torch.float32 or lse.dtype != torch.float32
            or not all(t.is_contiguous() for t in (q, k, v, bias, g, lse))):
        raise ValueError("the streaming dropattn_bwd takes contiguous tensors, g in q's type, "
                         "bias and lse in f32")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty((B, h, L), dtype=torch.float32, device=q.device)
    bits = torch.empty((B * h, L, (L + 31) // 32), dtype=torch.int32, device=q.device)
    fn = _fn("dropattn_bwd", "sskd_dropattn_bwd_stream",
             "i p p p p p p p p p p p i i i i f f u f f p")
    _build.check(
        fn(_DTYPES[q.dtype], *(_ptr(t) for t in (q, k, v, bias, g, lse, dsum, bits, dq, dk, dv)),
           B, h, L, d, 1.0 / (d**0.5), _scale_log2(d), int(seed) & _U32, float(p),
           1.0 / (1.0 - p), _stream(q)),
        "dropattn_bwd (streaming, tensor cores)",
    )
    _count(dropattn_bwd, d, True)
    dropattn_bwd.stream_launches += 1
    return dq, dk, dv, dsum, bits


dropattn_bwd.launches = 0
dropattn_bwd.tc_launches = 0  # the launches on the tensor cores: all of them
dropattn_bwd.stream_launches = 0  # those that streamed the head ("tc_stream")
# those on dropattn_bwd_tc_3pass_kernel (the "tc" route at DROPATTN_BWD_THREE_PASS)
dropattn_bwd.three_pass_launches = 0
dropattn_bwd.head_dim_launches = {}


def dropattn_keep_mask_kernel(seed: int, BH: int, L: int, p: float) -> torch.Tensor:
    """The keep-mask [BH, L, L] (bool, on the card) as the kernels' own
    generator draws it (csrc/philox.cuh through dropattn_fwd.cu), for
    holding it against :func:`dropout_keep_mask`. Not a path kernel: it has
    no launch count."""
    out = torch.empty((BH, L, L), dtype=torch.uint8, device="cuda")
    fn = _fn("dropattn_fwd", "sskd_dropattn_keep_mask", "p i i u f p")
    _build.check(fn(_ptr(out), BH, L, int(seed) & _U32, float(p), _stream(out)),
                 "dropattn_keep_mask")
    return out.bool()


class _DropoutAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, p, seed):
        out, lse = dropattn_fwd(q, k, v, bias, p, seed)
        ctx.save_for_backward(q, k, v, bias, lse)
        ctx.p, ctx.seed = p, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, lse = ctx.saved_tensors
        dq, dk, dv = dropattn_bwd(q, k, v, bias, ctx.p, ctx.seed, lse, g)
        return dq, dk, dv, None, None, None


def dropout_attention(q, k, v, bias, p: float, seed: int):
    """Training attention: ``dropout_p(softmax(q k^T / sqrt(d) + bias)) v``
    for q, k, v [B, h, L, d] (bf16 or f32), ``bias`` [B, L] additive over key
    positions (no gradient) and an integer ``seed`` (its low 32 bits key the
    mask; the same seed gives the same mask). Differentiable in q, k, v: the
    backward kernel regenerates the mask."""
    return _DropoutAttention.apply(q, k, v, bias.detach().float(), float(p), int(seed))
