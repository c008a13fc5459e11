"""The tensor-core kernels' arithmetic, written out in torch on the CPU.

``flash_tc`` follows csrc/flash_attn.cu ``flash_fwd_tc_kernel``,
``dropattn_fwd_tc`` csrc/dropattn_fwd.cu ``dropattn_fwd_tc_kernel`` and
``dropattn_bwd_tc`` csrc/dropattn_bwd.cu ``dropattn_bwd_tc_kernel``, step by
step, with what differs from the plain versions beyond summation order:

- every product is a chain of mma.sync m16n8k16 steps: a step adds its 16
  exact bf16 products to the f32 accumulator (exactly, in float64 here) and
  truncates the sum toward zero to f32;
- the scale and log2(e) are folded into the scores, and each probability is
  one 2^x, taken here as the f32 result scaled by (1 - 2^-22): ex2.approx's
  own error, in the direction that lowers every probability;
- the flash kernel's online softmax over 64-key tiles, each exponent one
  fma on a tile whose keys are all live, p rounded to bf16 after its f32
  sum has taken it;
- the dropout forward's two passes: the row's max and sum of 2^x in log2
  units, lse = max + log2(sum), then each probability already normalised
  as 2^(s * scale * log2(e) + (bias - lse) * log2(e)), rounded to bf16
  after the keep-mask and 1 / (1 - p).

``cell_gather_tc`` follows the schedule of csrc/cell_gather.cu
``cell_gather_tc_kernel``: the (query, slot) pairs sorted by cell, runs of
8 moved to cell boundaries, each run's cells taken in turn and each cell's
queries eight at a time, with exact integer dots and the kernel's order of
the two scale products.

The kernels themselves run only on the card; these versions let the CPU
tests hold the error bounds that the card's checks use against the new
arithmetic and the JAX kernels.
"""

import bisect
import math
from collections import Counter

import torch

LOG2E = math.log2(math.e)
NEG = float(torch.finfo(torch.float32).min) / 2
EX2_ERR = 1.0 - 2.0**-22


def _trunc32(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None) -> torch.Tensor:
    """acc + a @ b over the last two dims, 16-deep steps truncated to f32;
    ``a`` and ``b`` hold bf16 values."""
    a, b = a.double(), b.double()
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32) if acc is None
           else acc)
    for k0 in range(0, a.shape[-1], 16):
        out = _trunc32(out.double() + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :])
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_tc(q, k, v, mask):
    """The bf16 flash kernel's result for q, k, v [B, h, L, d] (bf16) and a
    key keep-mask [B, L] (None = all)."""
    B, h, L, d = q.shape
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    keep = (torch.ones(B, L) if mask is None else mask.float())[:, None, None, :]
    qf, kf, vf = q.float(), k.float(), v.float()
    m2 = torch.full((B, h, L, 1), NEG)
    l = torch.zeros(B, h, L, 1)
    o = torch.zeros(B, h, L, d)
    for k0 in range(0, L, 64):
        kt, vt, mt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64], keep[..., k0:k0 + 64]
        acc = mma(qf, kt.transpose(-1, -2))
        s2 = torch.where(mt > 0, acc * scale_log2, NEG)
        mx = torch.maximum(m2, s2.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m2 - mx) * EX2_ERR
        m2 = mx
        # a whole tile of live keys (a ragged last tile has slots past L)
        # takes each exponent as one fma of the raw sum
        live = (mt > 0).all(dim=-1, keepdim=True) & (mt.shape[-1] == 64)
        fused = (acc.double() * scale_log2.double() - m2.double()).float()
        p = torch.exp2(torch.where(live, fused, s2 - m2)) * EX2_ERR
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = mma(_bf16(p), vt, o * alpha)
    return (o / l.clamp(min=1e-30)).to(q.dtype)


def dropattn_fwd_tc(q, k, v, bias, p, keep_mask, fault=1.0):
    """(out, lse) of the bf16 forward kernel for q, k, v [B, h, L, d] (bf16),
    bias [B, L] f32 and ``keep_mask`` [B, h, L, L] (bool) or None at p = 0.
    ``fault`` scales every probability (a test's deliberate error)."""
    B, h, L, d = q.shape
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    acc = mma(q.float(), k.float().transpose(-1, -2)).double()
    bias2 = (bias.float() * LOG2E)[:, None, None, :]
    x = (acc * scale_log2.double() + bias2.double()).float()  # one fma
    # pass 1: max and sum in log2 units (the f32 sum of the kernel's lanes)
    m2 = x.amax(dim=-1, keepdim=True)
    l = (torch.exp2(x - m2) * EX2_ERR).sum(dim=-1, keepdim=True)
    lse2 = m2 + torch.log2(l)
    # pass 2: the normalised probability as one exp2 of one fma
    shift = (bias2 - lse2).double()
    probs = torch.exp2((acc * scale_log2.double() + shift).float()) * EX2_ERR * fault
    pd = probs if keep_mask is None else torch.where(keep_mask, probs * inv, 0.0)
    out = mma(_bf16(pd), v.float())
    return out.to(q.dtype), (lse2 * math.log(2.0))[..., 0]


def dropattn_bwd_tc(q, k, v, bias, p, seed, lse, g, keep_mask):
    """(dq, dk, dv) of the bf16 backward kernel for q, k, v, g [B, h, L, d]
    (bf16), bias [B, L] f32, the forward's lse [B, h, L] and ``keep_mask``
    [B, h, L, L] (bool) or None at p = 0."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    shift = (bias.float() * LOG2E)[:, None, None, :] - (lse.float() * LOG2E)[..., None]
    x2 = (mma(qf, kf.transpose(-1, -2)).double() * scale_log2.double()
          + shift.double()).float()  # one fma
    probs = torch.exp2(x2) * EX2_ERR
    dp = mma(gf, vf.transpose(-1, -2))
    if keep_mask is None:
        pd, dprobs = probs, dp
    else:
        pd = torch.where(keep_mask, probs * inv, 0.0)
        dprobs = torch.where(keep_mask, dp * inv, 0.0)
    D = (dprobs * probs).sum(dim=-1, keepdim=True)
    ds = _bf16(probs * (dprobs - D) * scale)
    dv = mma(_bf16(pd).transpose(-1, -2), gf)
    dq = mma(ds, kf)
    dk = mma(ds.transpose(-1, -2), qf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


CELL_RUN = 8  # csrc/cell_gather.cu TC_RUN


def cell_gather_tc(q_in, q_scale, corpus, row_scales, probe, rpc):
    """(scores [B, nprobe, rpc] f32, loads): the int8 tensor-core cell
    gather's result for int8 ``q_in`` [B, D] and ``corpus`` [P, D], and how
    many times its blocks bring each cell into shared memory (a Counter by
    cell; every tile of a cell is loaded by the same runs). A pair no run
    scores stays NaN."""
    B, nprobe = probe.shape
    n = B * nprobe
    cells, order = torch.sort(probe.reshape(-1), stable=True)
    cl, od = cells.tolist(), order.tolist()
    out = torch.full((n, rpc), float("nan"))
    loads = Counter()
    for run in range((n + CELL_RUN - 1) // CELL_RUN):
        s, e = run * CELL_RUN, min(run * CELL_RUN + CELL_RUN, n)
        if s > 0:
            s = max(s, bisect.bisect_right(cl, cl[s - 1]))
        if s >= e:
            continue
        e = bisect.bisect_right(cl, cl[e - 1])
        g = s
        while g < e:
            c, g_end = cl[g], g + 1
            while g_end < e and cl[g_end] == c:
                g_end += 1
            loads[c] += 1
            rows = corpus[c * rpc:(c + 1) * rpc].to(torch.int64)
            for q0 in range(g, g_end, 8):
                pairs = od[q0:min(q0 + 8, g_end)]
                bs = [pair // nprobe for pair in pairs]
                dots = (rows @ q_in[bs].to(torch.int64).T).to(torch.float32)  # exact
                scores = (dots * q_scale[bs]) * row_scales[c * rpc:(c + 1) * rpc, None]
                out[pairs] = scores.T
            g = g_end
    return out.view(B, nprobe, rpc), loads
