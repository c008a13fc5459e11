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

The f32 routes (``flash_fwd_tc_tf32_kernel`` and
``dropattn_fwd_tc_tf32_kernel`` at head dims 16, 32 and 64,
``dropattn_bwd_tc_tf32_kernel``, and the streaming backward at head dims 16,
32 and 64) take each product as three TF32 products
(``mma_tf32``): each operand rounded to TF32 as cvt.rna.tf32.f32 does (10
mantissa bits, to nearest, ties away) into a hi term and its remainder into
a lo term, each 8-deep step of mma.sync m16n8k8 adding hi hi to the
accumulator and lo hi, hi lo to one of their own, each step's 8 exact
products added to its accumulator and the sum truncated toward zero, as
``mma``'s; the two accumulators added once at the end. The softmax is the CUDA-core
kernels' in natural units (f32 exp, nothing folded). ``flash_tf32`` and
``dropattn_fwd_tf32`` (one online pass over 64-key tiles, the kept p times
1 / (1 - p) into p v in the tile's slot order, one division at the end)
take any head dim: the f32 kernels are one template instantiated at head
dims 16, 32 and 64, the sums over the same 64-key tiles at each.
``dropattn_bwd_tc_3pass`` follows ``dropattn_bwd_tc_3pass_kernel`` (bf16 at
head dim 16): passes 1 and 2 as ``dropattn_bwd_tc`` over the query rows, then
S^T = k q^T and dP^T = v g^T with the keys as rows, each probability from the
key's bias and the query's lse, dv and dk over 16-query steps; every sum is
``dropattn_bwd_tc``'s, so the two give the same bits.
``dropattn_bwd_tf32`` follows the f32 backward,
its dq steps in the kernel's key order, its D divided by the row's
sum of probabilities (``normalize=False``: before that repair, D as the
plain pair forms it); ``passes=1`` gives the
one-pass TF32 product the tests show the 1e-5 checks would catch.
``dropattn_bwd_stream_tc`` and ``dropattn_bwd_stream_tf32`` follow the
streaming backward (csrc/dropattn_bwd.cu route 2) kernel by kernel: D and
the keep bits over 64-key tiles, dq over the same tiles, dk and dv over
64-query tiles from S^T and dP^T, each sum on one chain across the tiles
(``mma_tf32_pair`` carries the f32 route's two accumulators).
``tf32_fragment_keys`` and ``tf32_forward_fragment_keys`` write out which
keys of a chunk each lane of the f32 backward and forward holds, and
``fragment_banks`` which shared-memory banks the f32 kernels' fragment
reads hit.

``tile_gather_tc`` follows the schedule of csrc/gather_tc.cuh, the
gather that ``cell_gather_tc_kernel`` and ``bin_gather_tc_kernel`` share:
runs of entries moved to the boundaries of equal cells, each run's groups
taken in turn, each group's 16-row tiles (rows past the corpus read as
zero bytes) against its queries eight at a time, exact integer dots (int8
rows, or packed int4 rows through ``packed_tile_dot``, which the kernel
scores one staged query at a time: the same exact sums), the kernels' order
of the two scale products and NEG_INF at rows >= valid_n.
``cell_gather_tc`` gives it the pairs sorted by cell in runs of 8;
``bin_gather_tc`` 128-row bins, in the pairs' own order or sorted by bin.
``bin_gather_bf16_tc`` follows ``bin_gather_bf16_tc_kernel``: bf16 rows
against the f32 query split exactly into three bf16 terms
(``split_bf16x3``), the terms as columns 0-2 of an 8-column B operand,
one ``mma`` a 16-dim step over rows zero-filled to the step count, and
each score the sum of the three columns, the smallest first.

``bin_gather_f32_tc`` follows ``bin_gather_f32_tc_kernel`` (f32 rows): the
entries in runs (the pairs' own order, one a run, or sorted by bin in runs of
32), each run cut into groups of equal neighbouring bins, each group's bin
read once for all its queries, each score three TF32 products a product
(``mma_tf32``) over the row zero-filled to the 32-float chunks, then the row
scale and the sentinel.

``binmax_strided_tc`` follows csrc/binmax.cu ``binmax_strided_tc_kernel``:
logical block j as two blocks of four warps, each warp 16 row positions of
every tile j, j + blocks, ... in increasing order, queries in chunks of 64
as 8-query groups, a running best replaced only when strictly greater, and
the C-fragment layout in which each lane writes its bins. ``binmax_tc``
follows ``binmax_tc_kernel``: the units of four warps, a warp a bin of 128
contiguous rows at a time as eight 16-row tiles (rows past the corpus read
as zeros, masked with their stale scales), the masked running maximum in
the C-fragment layout, and its reduction (the two row halves, then the
lanes' grp bits; grp 0 writes). Both take packed int4 rows (uint8, the
halves layout) as the kernels do: ``unpack_i4_words`` writes out
``unpack_i4``'s logic operations on the 32-bit registers that ldmatrix
gives, and ``packed_tile_dot`` the two mma a packed step (the low nibbles
against the first half of the queries, the high ones against the second),
the 16-fold sums and their shift back, over rows zero-filled to the step
count as the kernels' copies leave them.

``f32_tile_scores`` writes out the order of csrc/f32_tile.cuh, which both
f32 kernels of csrc/binmax.cu take: each score one fma chain over the row's
floats in order (each step the exact product added in float64 and rounded
once to f32). ``binmax_f32`` and ``binmax_strided_f32`` take the bins'
maxima of those scores, the strided one visiting each block's tiles in
increasing order with a strict compare.

The kernels themselves run only on the card; these versions let the CPU
tests hold the error bounds that the card's checks use against the new
arithmetic and the JAX kernels.
"""

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


def dropattn_bwd_tc_3pass(q, k, v, bias, p, seed, lse, g, keep_mask):
    """(dq, dk, dv) of ``dropattn_bwd_tc_3pass_kernel`` (bf16) for the
    arguments of ``dropattn_bwd_tc``: dq from the query rows' S and dP; dv
    and dk from S^T = k q^T and dP^T = v g^T with the keys as rows, each
    probability 2^(s^T scale log2(e) + (bias_key - lse_query) log2(e)), the
    keep bit of (query, key) and the query's D read back."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    bias2 = (bias.float() * LOG2E)[:, None, :]  # [B, 1, keys]
    lse2 = lse.float() * LOG2E  # [B, h, queries]
    # passes 1 and 2: the query rows
    x2 = (mma(qf, kf.transpose(-1, -2)).double() * scale_log2.double()
          + (bias2[:, :, None, :] - lse2[..., None]).double()).float()
    probs = torch.exp2(x2) * EX2_ERR
    dp = mma(gf, vf.transpose(-1, -2))
    dprobs = dp if keep_mask is None else torch.where(keep_mask, dp * inv, 0.0)
    D = (dprobs * probs).sum(dim=-1, keepdim=True)
    dq = mma(_bf16(probs * (dprobs - D) * scale), kf)
    # pass 3: the keys as rows, [.., key, query]
    x2t = (mma(kf, qf.transpose(-1, -2)).double() * scale_log2.double()
           + (bias2[:, :, :, None] - lse2[:, :, None, :]).double()).float()
    probs_t = torch.exp2(x2t) * EX2_ERR
    dpt = mma(vf, gf.transpose(-1, -2))
    keep_t = None if keep_mask is None else keep_mask.transpose(-1, -2)
    if keep_t is None:
        pd_t, dprobs_t = probs_t, dpt
    else:
        pd_t = torch.where(keep_t, probs_t * inv, 0.0)
        dprobs_t = torch.where(keep_t, dpt * inv, 0.0)
    ds_t = _bf16(probs_t * (dprobs_t - D.transpose(-1, -2)) * scale)
    dv = mma(_bf16(pd_t), gf)
    dk = mma(ds_t, qf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 rounds it and as the
    kernels' tf32_rna computes it (csrc/mma_common.cuh): the low 13 bits of
    the pattern cleared after adding half of them (to nearest, ties away
    from zero; the sign bit is untouched)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in f32)."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def mma_tf32_pair(a: torch.Tensor, b: torch.Tensor, big: torch.Tensor, small: torch.Tensor,
                  passes: int = 3, rounded: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) after adding a @ b over the last two dims as the f32
    tensor-core routes take it: 8-deep steps, each adding hi hi to ``big``
    and lo hi, hi lo to ``small``, each product's exact sum added and
    truncated toward zero to f32. With ``rounded`` (the streaming
    backward's long sums, ``mma_3xtf32_rn``) each step's hi hi starts from
    zero, is truncated on its own and is added to ``big`` rounded to
    nearest. A kernel that carries both accumulators over several tiles adds
    them once, at its end. At ``passes`` 1 only hi hi: one TF32 pass."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    for k0 in range(0, a.shape[-1], 8):
        step = slice(k0, k0 + 8)
        if passes == 3:
            for x, y in ((al, bh), (ah, bl)):
                small = _trunc32(small.double() + x[..., step].double() @ y[..., step, :].double())
        hh = ah[..., step].double() @ bh[..., step, :].double()
        big = big + _trunc32(hh) if rounded else _trunc32(big.double() + hh)
    return big, small


def mma_tf32(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None,
             passes: int = 3) -> torch.Tensor:
    """acc + a @ b (``mma_tf32_pair`` from ``acc`` and 0), the two
    accumulators added at the end."""
    big = (torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32) if acc is None
           else acc)
    big, small = mma_tf32_pair(a, b, big, torch.zeros_like(big), passes)
    return big + small


def flash_tf32(q, k, v, mask, passes: int = 3):
    """The f32 flash kernels' result for q, k, v [B, h, L, d] (f32, any head
    dim) and a key keep-mask [B, L] (None = all): 64-key tiles, the online
    softmax in natural units, both products on ``mma_tf32``."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    keep = (torch.ones(B, L) if mask is None else mask.float())[:, None, None, :]
    m = torch.full((B, h, L, 1), NEG)
    l = torch.zeros(B, h, L, 1)
    o = torch.zeros(B, h, L, d)
    for k0 in range(0, L, 64):
        kt, vt, mt = k[:, :, k0:k0 + 64], v[:, :, k0:k0 + 64], keep[..., k0:k0 + 64]
        s = torch.where(mt > 0, mma_tf32(q, kt.transpose(-1, -2), passes=passes) * scale, NEG)
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - mx)
        m = mx
        p = torch.exp(s - m)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = mma_tf32(p, vt, o * alpha, passes=passes)
    return o / l.clamp(min=1e-30)


# the keys of a 16-key chunk in the order of the f32 backward's dq steps:
# step s takes keys 4 tig + 2 s (k = tig) and 4 tig + 2 s + 1 (k = tig + 4)
_DQ_KEY_ORDER = [4 * t + 2 * s + b for s in range(2) for b in range(2) for t in range(4)]


def _row_d(dprobs, probs, normalize: bool):
    """D of each row: sum(dprobs * probs), on the f32 kernels over
    sum(probs) (csrc/dropattn_bwd.cu normalized_dsum; 0 where that is 0).
    ``normalize=False`` is the kernels' arithmetic before that division."""
    D = (dprobs * probs).sum(dim=-1, keepdim=True)
    if not normalize:
        return D
    total = probs.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, D / torch.where(total > 0, total, 1.0), 0.0)


def dropattn_bwd_tf32(q, k, v, bias, p, lse, g, keep_mask, passes: int = 3,
                      normalize: bool = True):
    """(dq, dk, dv) of the f32 backward kernel at head dim 64 for q, k, v, g
    [B, h, L, d] (f32), bias [B, L], the forward's lse [B, h, L] and
    ``keep_mask`` [B, h, L, L] (bool) or None at p = 0; D as ``_row_d``."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    s = mma_tf32(q, k.transpose(-1, -2), passes=passes) * scale + bias.float()[:, None, None, :]
    probs = torch.exp(s - lse.float()[..., None])
    dp = mma_tf32(g, v.transpose(-1, -2), passes=passes)
    if keep_mask is None:
        pd, dprobs = probs, dp
    else:
        pd = torch.where(keep_mask, probs * inv, 0.0)
        dprobs = torch.where(keep_mask, dp * inv, 0.0)
    D = _row_d(dprobs, probs, normalize)
    ds = probs * (dprobs - D) * scale
    dv = mma_tf32(pd.transpose(-1, -2), g, passes=passes)
    dk = mma_tf32(ds.transpose(-1, -2), q, passes=passes)
    Lp = (L + 15) // 16 * 16  # keys past L: ds 0 and zero rows of k
    order = torch.tensor([c + j for c in range(0, Lp, 16) for j in _DQ_KEY_ORDER])
    ds_p = torch.nn.functional.pad(ds, (0, Lp - L))[..., order]
    k_p = torch.nn.functional.pad(k, (0, 0, 0, Lp - L))[..., order, :]
    dq = mma_tf32(ds_p, k_p, passes=passes)
    return dq, dk, dv


STREAM_TILE = 64  # csrc/dropattn_bwd.cu DS_TILE: the rows of a streamed tile


def _stream_tiles(L: int) -> list[tuple[int, int]]:
    return [(a, min(a + STREAM_TILE, L)) for a in range(0, L, STREAM_TILE)]


def dropattn_bwd_stream_tc(q, k, v, bias, p, lse, g, keep_mask):
    """(dq, dk, dv) of the bf16 streaming backward (csrc/dropattn_bwd.cu
    route 2) for q, k, v, g [B, h, L, d] (bf16), bias [B, L] f32, the
    forward's lse [B, h, L] and ``keep_mask`` [B, h, L, L] (bool) or None at
    p = 0, kernel by kernel over 64-row tiles:

    - K1, per 64-key tile: S = q k^T and dP = g v^T on ``mma`` (16-deep
      steps over d), each probability one exp2 of one fma of the score with
      scale * log2(e) and (bias - lse) * log2(e), D = sum(dprobs * probs)
      summed tile after tile;
    - K2: S and dP again, ds = probs (dprobs - D) scale rounded to bf16, dq
      on one truncating chain of 16-deep steps over the tiles;
    - K3, per 64-query tile: S^T = k q^T and dP^T = v g^T (the same sums
      with the operands' roles swapped), pd^T and ds^T rounded to bf16, dv
      and dk each on one chain over the tiles."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    bias2 = bias.float() * LOG2E  # [B, L], one f32 product as the kernels take it
    lse2 = lse.float() * LOG2E    # [B, h, L]

    def probs(acc, shift):  # one fma, one exp2
        return torch.exp2((acc.double() * scale_log2.double() + shift.double()).float()) * EX2_ERR

    def rows_tile(a, b):  # K1 and K2: S and dP of keys a..b, probs, dprobs
        s = mma(qf, kf[:, :, a:b].transpose(-1, -2))
        dp = mma(gf, vf[:, :, a:b].transpose(-1, -2))
        pr = probs(s, bias2[:, None, None, a:b] - lse2[..., None])
        keep = None if keep_mask is None else keep_mask[..., a:b]
        return pr, dp if keep is None else torch.where(keep, dp * inv, 0.0)

    D = torch.zeros(B, h, L, 1)
    for a, b in _stream_tiles(L):
        pr, dprobs = rows_tile(a, b)
        D = D + (dprobs * pr).sum(dim=-1, keepdim=True)
    dq = torch.zeros(B, h, L, d)
    for a, b in _stream_tiles(L):
        pr, dprobs = rows_tile(a, b)
        dq = mma(_bf16(pr * (dprobs - D) * scale), kf[:, :, a:b], dq)
    dk, dv = torch.zeros(B, h, L, d), torch.zeros(B, h, L, d)
    for a, b in _stream_tiles(L):
        st = mma(kf, qf[:, :, a:b].transpose(-1, -2))  # [.., keys, queries]
        dpt = mma(vf, gf[:, :, a:b].transpose(-1, -2))
        pr = probs(st, bias2[:, None, :, None] - lse2[:, :, None, a:b])
        keep = None if keep_mask is None else keep_mask[..., a:b, :].transpose(-1, -2)
        pd = pr if keep is None else torch.where(keep, pr * inv, 0.0)
        dprobs = dpt if keep is None else torch.where(keep, dpt * inv, 0.0)
        ds = _bf16(pr * (dprobs - D[..., a:b, 0][:, :, None, :]) * scale)
        dv = mma(_bf16(pd), gf[:, :, a:b], dv)
        dk = mma(ds, qf[:, :, a:b], dk)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def dropattn_bwd_stream_tf32(q, k, v, bias, p, lse, g, keep_mask, passes: int = 3,
                             normalize: bool = True):
    """(dq, dk, dv) of the f32 streaming backward at head dim 32 or 64 for
    q, k, v, g [B, h, L, d] (f32), bias [B, L], the forward's lse [B, h, L]
    and ``keep_mask`` [B, h, L, L] (bool) or None at p = 0: the kernels of
    ``dropattn_bwd_stream_tc`` with every product three TF32 products
    (``mma_tf32_pair``) and each probability expf(s * scale + bias - lse) in
    natural units. K2's 8-deep steps take each 16-key chunk in the key order
    of the f32 kernels (K and V rows stored in slot order); dq, dk and dv
    each carry both accumulators over the tiles and add them at the end. K1
    sums dprobs * probs and probs tile after tile and divides (``_row_d``)."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    lsef = lse.float()

    def rows_tile(a, b):
        s = mma_tf32(q, k[:, :, a:b].transpose(-1, -2), passes=passes) * scale
        pr = torch.exp(s + bias.float()[:, None, None, a:b] - lsef[..., None])
        dp = mma_tf32(g, v[:, :, a:b].transpose(-1, -2), passes=passes)
        keep = None if keep_mask is None else keep_mask[..., a:b]
        return pr, dp if keep is None else torch.where(keep, dp * inv, 0.0)

    D, total = torch.zeros(B, h, L, 1), torch.zeros(B, h, L, 1)
    for a, b in _stream_tiles(L):
        pr, dprobs = rows_tile(a, b)
        D = D + (dprobs * pr).sum(dim=-1, keepdim=True)
        total = total + pr.sum(dim=-1, keepdim=True)
    if normalize:
        D = torch.where(total > 0, D / torch.where(total > 0, total, 1.0), 0.0)
    dq = dq_lo = torch.zeros(B, h, L, d)
    for a, b in _stream_tiles(L):
        pr, dprobs = rows_tile(a, b)
        ds = pr * (dprobs - D) * scale
        n = (b - a + 15) // 16 * 16  # keys past L: ds 0 and zero rows of k
        order = torch.tensor([c + j for c in range(0, n, 16) for j in _DQ_KEY_ORDER])
        ds_p = torch.nn.functional.pad(ds, (0, n - (b - a)))[..., order]
        k_p = torch.nn.functional.pad(k[:, :, a:b], (0, 0, 0, n - (b - a)))[..., order, :]
        dq, dq_lo = mma_tf32_pair(ds_p, k_p, dq, dq_lo, passes, rounded=True)
    dk = dk_lo = dv = dv_lo = torch.zeros(B, h, L, d)
    for a, b in _stream_tiles(L):
        st = mma_tf32(k, q[:, :, a:b].transpose(-1, -2), passes=passes) * scale
        pr = torch.exp(st + bias.float()[:, None, :, None] - lsef[:, :, None, a:b])
        dpt = mma_tf32(v, g[:, :, a:b].transpose(-1, -2), passes=passes)
        keep = None if keep_mask is None else keep_mask[..., a:b, :].transpose(-1, -2)
        pd = pr if keep is None else torch.where(keep, pr * inv, 0.0)
        dprobs = dpt if keep is None else torch.where(keep, dpt * inv, 0.0)
        ds = pr * (dprobs - D[..., a:b, 0][:, :, None, :]) * scale
        dv, dv_lo = mma_tf32_pair(pd, g[:, :, a:b], dv, dv_lo, passes, rounded=True)
        dk, dk_lo = mma_tf32_pair(ds, q[:, :, a:b], dk, dk_lo, passes, rounded=True)
    return dq + dq_lo, dk + dk_lo, dv + dv_lo


def _key_slot(t: int) -> int:
    """csrc/attn_common.cuh key_slot: the slot of key t of a 16-key chunk."""
    return 8 * ((t >> 1) & 1) + 2 * (t >> 2) + (t & 1)


def _slot_row(r: int) -> int:
    """csrc/attn_common.cuh slot_row: the shared row of key r of a tile
    whose 16-key chunks are stored in slot order."""
    return (r & ~15) + _key_slot(r & 15)


# the keys of a 64-key tile in the order of its shared rows (slot order)
_SLOT_ORDER = sorted(range(64), key=_slot_row)


def dropattn_fwd_tf32(q, k, v, bias, p, keep_mask, passes: int = 3):
    """(out, lse) of the f32 forward kernels for q, k, v [B, h, L, d] (f32,
    any head dim), bias [B, L] and ``keep_mask`` [B, h, L, L] (bool) or
    None at p = 0: 64-key tiles, s = qk * scale + bias, the running max and
    sum in natural units (the sum over every key, kept or not), the
    accumulator rescaled a tile, the kept p times 1 / (1 - p) into p v whose
    8-deep steps take the tile's keys in slot order, out = o / sum and lse =
    max + log(sum)."""
    B, h, L, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    bias4 = bias.float()[:, None, None, :]
    m = torch.full((B, h, L, 1), -math.inf)
    l = torch.zeros(B, h, L, 1)
    o = torch.zeros(B, h, L, d)
    for k0 in range(0, L, 64):
        n = min(64, L - k0)
        kt, vt = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        s = mma_tf32(q, kt.transpose(-1, -2), passes=passes) * scale + bias4[..., k0:k0 + n]
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(mx == -math.inf, 0.0, mx)
        alpha = torch.exp(m - base)
        m = mx
        e = torch.exp(s - base)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        pd = e if keep_mask is None else torch.where(keep_mask[..., k0:k0 + n], e * inv, 0.0)
        # keys past L: p 0 and zero rows of v, in the slots the kernel gives them
        pd = torch.nn.functional.pad(pd, (0, 64 - n))[..., _SLOT_ORDER]
        vt = torch.nn.functional.pad(vt, (0, 0, 0, 64 - n))[..., _SLOT_ORDER, :]
        o = mma_tf32(pd, vt, o * alpha, passes=passes)
    return o / l, (m + torch.log(l))[..., 0]


def tf32_forward_fragment_keys(d: int = 64):
    """What the f32 forward's lanes hold of a 64-key tile at head dim ``d``,
    from its index arithmetic (rows stored by slot_row at a stride of d + 4
    floats): ``stored[lane]`` the key in the shared row of score element
    e (0, 1) of tile nt (column 2 tig + e of tile nt is shared row nt * 8 +
    2 tig + e), ``used[lane]`` the key the kernel takes that element for (its
    bias and keep bit: 16 (nt >> 1) + 4 tig + 2 (nt & 1) + e),
    ``pv_rows[lane]`` the keys of the V rows step nt of p v reads as b0 and
    b1 (shared rows nt * 8 + 2 tig and + 1), and ``k_reads[lane]`` the (key,
    column) of each K value its score steps read, decoded from the address
    (nt * 8 + grp) * (d + 4) + ks * 8 + tig (b0) and + 4 (b1), ks < d / 8."""
    key_at = {_slot_row(r): r for r in range(64)}
    ld = d + 4
    stored, used, pv_rows, k_reads = [], [], [], []
    for lane in range(32):
        grp, tig = lane >> 2, lane & 3
        stored.append([key_at[nt * 8 + 2 * tig + e] for nt in range(8) for e in range(2)])
        used.append([16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + e
                     for nt in range(8) for e in range(2)])
        pv_rows.append([key_at[nt * 8 + 2 * tig + b] for nt in range(8) for b in range(2)])
        k_reads.append({(nt, ks, b): (key_at[addr // ld], addr % ld)
                        for nt in range(8) for ks in range(d // 8) for b in range(2)
                        for addr in [(nt * 8 + grp) * ld + ks * 8 + tig + 4 * b]})
    return stored, used, pv_rows, k_reads


def tf32_fragment_keys():
    """What the f32 backward's lanes hold of a 16-key chunk, from its index
    arithmetic: ``scores[lane][e_all]`` the key of score element e of tiles
    0 and 1 (column 2 tig + (e & 1) of tile nt is slot 8 nt + 2 tig + (e & 1),
    slot r holding the key whose key_slot is r), and ``dq_rows[lane][s][b]``
    the key of the k row that dq's step s reads as b0 (b = 0) or b1 (b = 1):
    slot 8 s + 2 tig + b."""
    key_at = {_key_slot(t): t for t in range(16)}
    scores, dq_rows = [], []
    for lane in range(32):
        tig = lane & 3
        scores.append([key_at[8 * nt + 2 * tig + (e & 1)] for nt in range(2) for e in range(2)])
        dq_rows.append([[key_at[8 * s + 2 * tig + b] for b in range(2)] for s in range(2)])
    return scores, dq_rows


def fragment_banks(d: int):
    """The shared-memory banks (32 of 4 bytes) that the f32 kernels' 4-byte
    fragment reads hit, lane by lane, at a row stride of d + 4 floats:
    ``"k"`` a score step's b0 (K row grp, column tig; b1 is four columns
    on), ``"v"`` a p v step's b0 (V row 2 tig, column grp; b1 is one row
    on); q's A fragment a0 (row grp, column tig) reads as K's b0 does."""
    ld = d + 4
    return {"k": [((lane >> 2) * ld + (lane & 3)) % 32 for lane in range(32)],
            "v": [(2 * (lane & 3) * ld + (lane >> 2)) % 32 for lane in range(32)]}


def ldmatrix_bank_groups(d: int) -> dict:
    """The 16-byte bank groups (eight to the 128 bytes the banks span) that
    one 8 x 8 matrix of an ``ldmatrix`` in the bf16 kernels reads, by the
    first row and column it starts at: its eight rows (row0 .. row0 + 7,
    8 bf16 from column col0) at a row stride of d + 8 bf16, for every
    matrix the kernels read (q's and V's at columns 0, 8, ... of 16-row
    steps, K's at 8-key tiles)."""
    ld = d + 8
    return {(row0, col0): [((row0 + r) * ld * 2 + col0 * 2) // 16 % 8 for r in range(8)]
            for row0 in range(0, 64, 8) for col0 in range(0, d, 8)}


CELL_RUN = 8  # csrc/cell_gather.cu TC_RUN
TC_TILE = 16  # csrc/gather_tc.cuh: rows a warp scores
BIN_W = 128


def _groups(cells, n, run_len):
    """The groups (start, end) of equal neighbouring cells each run scores,
    run by run: runs of ``run_len`` entries moved to cell boundaries (one
    entry a run, as it is, for run_len 1)."""
    if run_len == 1:
        return [(i, i, i + 1) for i in range(n)]
    out = []
    for run in range((n + run_len - 1) // run_len):
        s, e = run * run_len, min(run * run_len + run_len, n)
        while 0 < s < e and cells[s] == cells[s - 1]:
            s += 1
        if s >= e:
            continue
        while e < n and cells[e] == cells[e - 1]:
            e += 1
        g = s
        while g < e:
            g_end = g + 1
            while g_end < e and cells[g_end] == cells[g]:
                g_end += 1
            out.append((run, g, g_end))
            g = g_end
    return out


def tile_gather_tc(q_in, q_scale, corpus, row_scales, cells, order, per_query, rpc, run_len,
                   valid_n):
    """(scores [n_pairs, rpc] f32, loads) of the gather of csrc/gather_tc.cuh:
    ``cells`` [n] the cell of each entry, ``order`` [n] its pair (None: entry
    i is pair i), pair p = b * per_query + j against query b. ``loads``
    counts how many times a cell's tiles are brought into shared memory (a
    Counter by cell). A pair no run scores stays NaN."""
    n = len(cells)
    cl = [int(c) for c in cells]
    od = list(range(n)) if order is None else [int(p) for p in order]
    n_rows, d = corpus.shape
    packed = corpus.dtype == torch.uint8
    out = torch.full((n, rpc), float("nan"))
    loads = Counter()
    for _, g, g_end in _groups(cl, n, run_len):
        c = cl[g]
        loads[c] += 1
        for r0 in range(0, rpc, TC_TILE):  # the warps of the run, one tile each
            rows = c * rpc + r0 + torch.arange(min(TC_TILE, rpc - r0))
            live = rows < n_rows
            tile = torch.zeros(len(rows), d, dtype=torch.int64)
            tile[live] = corpus[rows[live]].to(torch.int64)  # past the corpus: zero bytes
            scale = torch.full((len(rows),), float("nan"))  # never read where dead
            scale[live] = row_scales[rows[live]]
            for q0 in range(g, g_end, 8):
                pairs = od[q0:min(q0 + 8, g_end)]
                bs = [pair // per_query for pair in pairs]
                dots = _tile_dot(tile, q_in[bs].to(torch.int64), packed).to(torch.float32)
                scores = (dots * q_scale[bs]) * scale[:, None]
                scores = torch.where((rows < valid_n)[:, None], scores, NEG)
                out[pairs, r0:r0 + len(rows)] = scores.T
    return out, loads


def cell_gather_tc(q_in, q_scale, corpus, row_scales, probe, rpc):
    """(scores [B, nprobe, rpc] f32, loads): the int8 tensor-core cell
    gather's result for int8 ``q_in`` [B, D] and ``corpus`` [P, D], and how
    many times its blocks bring each cell into shared memory (a Counter by
    cell; every tile of a cell is loaded by the same runs). A pair no run
    scores stays NaN."""
    B, nprobe = probe.shape
    cells, order = torch.sort(probe.reshape(-1), stable=True)
    out, loads = tile_gather_tc(q_in, q_scale, corpus, row_scales, cells, order, nprobe, rpc,
                                CELL_RUN, corpus.shape[0])
    return out.view(B, nprobe, rpc), loads


def bin_gather_tc(q_in, q_scale, corpus, row_scales, bins, valid_n, sort=False):
    """(scores [B, kb, 128] f32, loads) of the tensor-core bin gather over
    int8 or packed int4 rows in bins of 128 rows, the last one ragged: the
    (query, slot) pairs in their own order, one a warp (the wrapper's), or
    sorted by bin in runs of 8 as cell_gather takes its pairs (each distinct
    bin loaded once)."""
    B, kb = bins.shape
    if sort:
        cells, order = torch.sort(bins.reshape(-1), stable=True)
    else:
        cells, order = bins.reshape(-1), None
    out, loads = tile_gather_tc(q_in, q_scale, corpus, row_scales, cells, order, kb, BIN_W,
                                CELL_RUN if sort else 1, valid_n)
    return out.view(B, kb, BIN_W), loads


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 terms of f32 ``x`` (csrc/mma_common.cuh ``bf16_term``),
    as f32 tensors: t0 = bf16(x), t1 = bf16(x - t0), t2 = x - t0 - t1, each
    difference taken in f32."""
    t0 = _bf16(x)
    r = x - t0
    t1 = _bf16(r)
    return t0, t1, r - t1


def bin_gather_bf16_tc(q, corpus, row_scales, bins, valid_n):
    """Scores [B, kb, 128] f32 of ``bin_gather_bf16_tc_kernel`` for f32
    queries ``q`` [B, D] and bf16 rows ``corpus`` [N, D]: each (query, slot)
    pair's rows, zero-filled past the corpus and to the step count, times
    the query's three bf16 terms in columns 0-2 of an 8-column operand
    (``mma``: each 16-deep step's exact sum truncated to f32), each score
    (c2 + c1) + c0, then the row scale if any and NEG_INF at rows >=
    valid_n."""
    B, kb = bins.shape
    n, d = corpus.shape
    width = 16 * tc_steps(2 * d)  # the kernel's 32-byte steps, 16 bf16 each
    out = torch.empty(B, kb, BIN_W)
    for b in range(B):
        terms = torch.zeros(width, 8)
        for col, t in enumerate(split_bf16x3(q[b].to(torch.float32))):
            terms[:d, col] = t
        for slot in range(kb):
            rows = int(bins[b, slot]) * BIN_W + torch.arange(BIN_W)
            live = rows < n
            tile = torch.zeros(BIN_W, width)
            tile[live, :d] = corpus[rows[live]].float()
            acc = mma(tile, terms)
            scores = (acc[:, 2] + acc[:, 1]) + acc[:, 0]
            if row_scales is not None:
                scores = scores * row_scales[rows.clamp(max=n - 1)]
            out[b, slot] = torch.where(rows < valid_n, scores, NEG)
    return out


GF_CK, GF_SORT_RUN = 32, 32  # csrc/bin_gather.cu: floats a chunk, entries a sorted run


def bin_gather_f32_tc(q, corpus, row_scales, bins, valid_n, sort=False):
    """(scores [B, kb, 128] f32, loads) of ``bin_gather_f32_tc_kernel`` for
    f32 queries ``q`` [B, D] and f32 rows ``corpus`` [N, D]: the (query,
    slot) pairs in their own order, one a run, or sorted by bin (one stable
    sort) in runs of 32 entries; each run cut into groups of equal
    neighbouring bins, each group's bin brought in once (``loads``, a
    Counter by bin) for all its queries; each score ``mma_tf32`` of the
    row and the query, both zero-filled to a whole number of 32-float
    chunks, then the row scale if any and NEG_INF at rows >= valid_n. A
    pair no run scores stays NaN."""
    B, kb = bins.shape
    n, d = corpus.shape
    width = -(-d // GF_CK) * GF_CK
    if sort:
        cells, order = torch.sort(bins.reshape(-1), stable=True)
        run_len = GF_SORT_RUN
    else:
        cells, order, run_len = bins.reshape(-1), None, 1
    cl = [int(c) for c in cells]
    od = list(range(len(cl))) if order is None else [int(i) for i in order]
    out = torch.full((B * kb, BIN_W), float("nan"))
    loads = Counter()
    qp = torch.zeros(B, width)
    qp[:, :d] = q.float()
    for s in range(0, len(cl), run_len):
        e = min(s + run_len, len(cl))
        g = s
        while g < e:
            g_end = g + 1
            while g_end < e and cl[g_end] == cl[g]:
                g_end += 1
            c = cl[g]
            loads[c] += 1
            rows = c * BIN_W + torch.arange(BIN_W)
            live = rows < n
            tile = torch.zeros(BIN_W, width)
            tile[live, :d] = corpus[rows[live]].float()
            pairs = od[g:g_end]
            acc = mma_tf32(tile, qp[[pair // kb for pair in pairs]].T)  # [128, n_q]
            if row_scales is not None:
                acc = acc * row_scales[rows.clamp(max=n - 1)][:, None]
            out[pairs] = torch.where((rows < valid_n)[:, None], acc, NEG).T
            g = g_end
    return out.view(B, kb, BIN_W), loads


ST_WARPS, ST_PARTS, ST_QUERIES = 4, 2, 64  # csrc/binmax.cu


def unpack_i4_words(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/mma_common.cuh ``unpack_i4`` on 32-bit registers (int64 tensors of
    values < 2^32): each nibble n of a packed byte to the s8 value 16 (n - 8)
    in the high half of its byte, the low nibbles into ``lo`` and the high
    ones into ``hi``, two logic operations and one."""
    lo = ((words << 4) & 0xF0F0F0F0) ^ 0x80808080
    hi = (words & 0xF0F0F0F0) ^ 0x80808080
    return lo, hi


def _words(rows: torch.Tensor) -> torch.Tensor:
    """[R, 4 W] bytes (int64 values 0..255) -> [R, W] little-endian words."""
    b = rows.view(rows.shape[0], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _s8_bytes(words: torch.Tensor) -> torch.Tensor:
    """[R, W] words -> [R, 4 W] their bytes as s8 values."""
    b = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=-1).flatten(1)
    return b - 256 * (b >= 128)


def tc_steps(row_bytes: int) -> int:
    """The 32-byte steps of a row of ``row_bytes`` (csrc/mma_common.cuh
    tc_stride / 32)."""
    return ((row_bytes + 31) // 32 * 32 + 16) // 32


def packed_tile_dot(rows: torch.Tensor, qf: torch.Tensor) -> torch.Tensor:
    """int32 dots [R, G] of packed int4 rows (``rows`` [R, D/2] int64 byte
    values) with int8 queries ``qf`` [G, D], as the tensor-core kernels take
    them: the rows zero-filled to the step count, each step's low and high
    nibbles (``unpack_i4_words``) against the query halves zero-padded to
    it, the sums 16 times the dot, exact, shifted back."""
    half = rows.shape[1]
    width = 32 * tc_steps(half)
    padded = torch.zeros(rows.shape[0], width, dtype=torch.int64)
    padded[:, :half] = rows
    lo, hi = (_s8_bytes(w) for w in unpack_i4_words(_words(padded)))
    q = qf.to(torch.int64)
    q_lo, q_hi = (torch.zeros(q.shape[0], width, dtype=torch.int64) for _ in range(2))
    q_lo[:, :half], q_hi[:, :half] = q[:, :half], q[:, half:]
    acc16 = lo @ q_lo.T + hi @ q_hi.T
    assert acc16.abs().max().item() < 2**31 and (acc16 % 16 == 0).all()
    return acc16 >> 4


def _tile_dot(rows: torch.Tensor, qf: torch.Tensor, packed: bool) -> torch.Tensor:
    """Exact int32 dots [R, G] of a tile's rows (int8, or packed int4 bytes)
    with the chunk's queries."""
    return packed_tile_dot(rows, qf) if packed else rows @ qf.T


def binmax_strided_tc(q_in, corpus, row_scales, valid_n, blocks):
    """(maxima [blocks * 128, B] f32, rows [blocks * 128, B] int32) of the
    tensor-core strided pass over int8 or packed int4 rows, block by block
    and warp by warp."""
    n, d = corpus.shape
    B, packed = q_in.shape[0], corpus.dtype == torch.uint8
    n_tiles = (n + BIN_W - 1) // BIN_W
    rows_all = torch.zeros(n_tiles * BIN_W, d, dtype=torch.int64)
    rows_all[:n] = corpus.to(torch.int64)  # a ragged last tile: zero bytes
    scales_all = torch.full((n_tiles * BIN_W,), float("nan"))  # never read where dead
    scales_all[:n] = row_scales
    ng = 1 if B <= 8 else 2 if B <= 16 else 4 if B <= 32 else 8
    chunks = (B + ST_QUERIES - 1) // ST_QUERIES
    best = torch.full((blocks * BIN_W, B), NEG)
    rows_out = torch.zeros((blocks * BIN_W, B), dtype=torch.int32)
    frag_row, frag_col = _frag_layout(ng)
    for j in range(blocks):
        n_mine = (n_tiles - 1 - j) // blocks + 1
        for part in range(ST_PARTS):
            for chunk in range(chunks):
                q0 = chunk * ST_QUERIES
                nq = min(ng * 8, B - q0)
                qf = torch.zeros(ng * 8, q_in.shape[1], dtype=torch.int64)  # absent: zeros
                qf[:nq] = q_in[q0:q0 + nq].to(torch.int64)
                for warp in range(ST_WARPS):
                    t0 = part * 64 + warp * 16
                    run_best = torch.full((16, ng * 8), NEG)
                    run_i = torch.zeros((16, ng * 8), dtype=torch.int64)
                    for i in range(n_mine):  # tiles in increasing order
                        r = (j + i * blocks) * BIN_W + t0 + torch.arange(16)
                        acc = _tile_dot(rows_all[r], qf, packed).to(torch.float32)
                        s = torch.where((r < valid_n)[:, None], acc * scales_all[r][:, None], NEG)
                        better = s > run_best  # strictly: the lowest row keeps a tie
                        run_best = torch.where(better, s, run_best)
                        run_i = torch.where(better, i, run_i)
                    keep = frag_col < nq
                    fr, fc = frag_row[keep], frag_col[keep]
                    bins = j * BIN_W + t0 + fr
                    best[bins, q0 + fc] = run_best[fr, fc]
                    rows_out[bins, q0 + fc] = ((j + run_i[fr, fc] * blocks) * BIN_W + t0
                                               + fr).to(torch.int32)
    return best, rows_out


def _frag_layout(ng):
    """(row of 16, query column) of each C-fragment element, lane-major:
    lane (grp, tig), group n, element e hold row grp + 8 (e >> 1) and query
    n * 8 + 2 tig + (e & 1)."""
    lane, n_i, e = torch.meshgrid(torch.arange(32), torch.arange(ng), torch.arange(4),
                                  indexing="ij")
    rows = (lane >> 2) + 8 * (e >> 1)
    return rows.reshape(-1), (n_i * 8 + 2 * (lane & 3) + (e & 1)).reshape(-1)


def binmax_tc(q_in, corpus, row_scales, valid_n, units):
    """Bin maxima [ceil(N / 128), B] f32 of the tensor-core binmax over int8
    or packed int4 rows, unit by unit and warp by warp, with ``units`` units
    of four warps (the card's count fills it; the result does not depend on
    it). A bin no warp writes stays NaN."""
    n, d = corpus.shape
    B, packed = q_in.shape[0], corpus.dtype == torch.uint8
    n_bins = (n + BIN_W - 1) // BIN_W
    rows_all = torch.zeros(n_bins * BIN_W, d, dtype=torch.int64)
    rows_all[:n] = corpus.to(torch.int64)  # a ragged last bin: zero bytes
    scales_all = torch.full((n_bins * BIN_W,), float("nan"))  # stale where dead: masked
    scales_all[:n] = row_scales
    ng = 1 if B <= 8 else 2 if B <= 16 else 4 if B <= 32 else 8
    chunks = (B + ST_QUERIES - 1) // ST_QUERIES
    out = torch.full((n_bins, B), float("nan"))
    frag_row, frag_col = _frag_layout(ng)
    for chunk in range(chunks):
        q0 = chunk * ST_QUERIES
        nq = min(ng * 8, B - q0)
        qf = torch.zeros(ng * 8, q_in.shape[1], dtype=torch.int64)  # absent queries: zeros
        qf[:nq] = q_in[q0:q0 + nq].to(torch.int64)
        for unit in range(units):
            for warp in range(ST_WARPS):
                for b in range(unit * ST_WARPS + warp, n_bins, units * ST_WARPS):
                    mx = torch.full((32 * ng * 4,), NEG)  # the lanes' running maxima
                    for t in range(BIN_W // 16):  # the bin's tiles in order
                        r = b * BIN_W + t * 16 + torch.arange(16)
                        acc = _tile_dot(rows_all[r], qf, packed).to(torch.float32)
                        s = torch.where((r < valid_n)[:, None], acc * scales_all[r][:, None],
                                        NEG)
                        mx = torch.maximum(mx, s[frag_row, frag_col])
                    mx = mx.view(8, 4, ng, 4)  # grp, tig, n, e
                    halves = torch.maximum(mx[..., :2], mx[..., 2:])  # rows grp, grp + 8
                    m = halves.amax(dim=0)  # the shuffles over grp: [tig, n, e & 1]
                    tig, n_i, e = torch.meshgrid(torch.arange(4), torch.arange(ng),
                                                 torch.arange(2), indexing="ij")
                    col = (n_i * 8 + 2 * tig + e).reshape(-1)
                    keep = col < nq
                    out[b, q0 + col[keep]] = m.reshape(-1)[keep]
    return out


def f32_tile_scores(q, corpus):
    """Scores [N, B] f32 of every row against every query, each one fma
    chain over the row's floats in order."""
    qd, rows = q.double(), corpus.double()
    acc = torch.zeros(corpus.shape[0], q.shape[0], dtype=torch.float32)
    for k in range(corpus.shape[1]):
        acc = (acc.double() + rows[:, k:k + 1] * qd[:, k]).float()
    return acc


def _f32_masked(q, corpus, row_scales, valid_n):
    """The f32 kernels' masked scores, padded to whole 128-row tiles."""
    n = corpus.shape[0]
    s = f32_tile_scores(q, corpus)
    if row_scales is not None:
        s = s * row_scales[:, None]
    s = torch.where((torch.arange(n) < valid_n)[:, None], s, NEG)
    pad = -n % BIN_W
    return torch.cat([s, torch.full((pad, q.shape[0]), NEG)]) if pad else s


def binmax_f32(q, corpus, row_scales, valid_n):
    """Bin maxima [ceil(N / 128), B] of ``binmax_f32_kernel``."""
    return _f32_masked(q, corpus, row_scales, valid_n).view(-1, BIN_W, q.shape[0]).amax(dim=1)


def binmax_strided_f32(q, corpus, row_scales, valid_n, blocks):
    """(maxima, rows) [blocks * 128, B] of ``binmax_strided_f32_kernel``:
    block j visits tiles j, j + blocks, ... in order, a later tile taking a
    bin only when strictly greater."""
    B = q.shape[0]
    s = _f32_masked(q, corpus, row_scales, valid_n)
    n_tiles = s.shape[0] // BIN_W
    best = torch.full((blocks * BIN_W, B), NEG)
    first = torch.arange(blocks * BIN_W)[:, None].expand(-1, B)
    rows = first.clone()
    for j in range(blocks):
        lo, hi = j * BIN_W, (j + 1) * BIN_W
        for tile in range(j, n_tiles, blocks):
            cand = s[tile * BIN_W:(tile + 1) * BIN_W]
            better = cand > best[lo:hi]
            best[lo:hi] = torch.where(better, cand, best[lo:hi])
            rows[lo:hi] = torch.where(better, tile * BIN_W + torch.arange(BIN_W)[:, None],
                                      rows[lo:hi])
    return best, rows.to(torch.int32)
