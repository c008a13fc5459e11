"""Two-phase exact top-k over a device-resident corpus (port of
sskd_tpu/ops/topk_pallas.py).

Phase A, ``binmax`` (csrc/binmax.cu): the maximum score of every 128-row bin
for every query, ``[n_bins, B]``, without a ``[B, N]`` score matrix in device
memory. Extraction, plain torch: each query's top-kb bins by that maximum.
Phase B, ``bin_gather`` (csrc/bin_gather.cu): exact scores of the 128 rows of
each chosen bin, ``[B, kb, 128]``; a final top-k over those candidates is the
exact answer, because every one of a query's top-k rows lies in a bin whose
maximum is at least the k-th score, and at most k bins hold them.

The approx engine (:func:`sskd_tpu_torch.ops.topk.approx_topk`) needs one
pass only, ``binmax_strided`` (the second kernel of csrc/binmax.cu): the
maximum and the row that holds it, for bins whose rows lie far apart.

Each kernel wrapper launches its kernel on a CUDA tensor and counts the
launch in its ``launches`` attribute; on a CPU tensor it runs the kernel's
plain torch version (``binmax_plain``, ``bin_gather_plain``,
``binmax_strided_plain``), which repeats the kernel's arithmetic.
Each kernel has its routes (:func:`binmax_route`,
:func:`binmax_strided_route`, :func:`bin_gather_route`): int8 rows of at
most 1,024 bytes and packed int4 rows of at most 512 on the tensor cores,
counted also in ``tc_launches``; bf16 rows against f32 queries (the TPU
kernels' bf16 branch: each bf16 widened exactly, f32 sums), counted also in
``bf16_launches``, in ``bin_gather`` on the tensor cores up to 1,024 bytes
(the query split exactly into three bf16 terms, counted in both), in
``binmax`` and ``binmax_strided`` and past that on the CUDA cores; f32
rows of at most 1,024 floats in ``bin_gather`` on the tensor cores (each
product three TF32 products, counted in ``tc_launches`` and
``f32_tc_launches``); f32 rows in ``binmax`` and ``binmax_strided``, longer
f32 rows in ``bin_gather`` and longer int8 and int4 rows on the CUDA cores
(f32 and bf16 in ``binmax`` and ``binmax_strided`` through the
register-tiled score tile of csrc/f32_tile.cuh). Results
follow the JAX engine's contract: ``(vals [B, k] f32, idx [B, k] int32)``
with ``(-inf, -1)`` sentinels, where "-inf" is ``finfo(float32).min / 2``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sskd_tpu_torch.ops import _build
from sskd_tpu_torch.ops.quant import quantize_rows, unpack_int4

NEG_INF = float(torch.finfo(torch.float32).min) / 2
BIN_W = 128  # rows per bin
K_MAX = 256  # largest k the two-phase engine serves
_MODES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2, torch.bfloat16: 3}
_QUANTIZED = (1, 2)  # the modes of int8 queries and row scales
_PLAIN_ROWS = 1 << 18  # rows per chunk of the plain versions' score matrix
# the longest row the tensor-core routes take, in bytes (csrc/binmax.cu
# ST_MAX_ROW_BYTES, csrc/gather_tc.cuh TC_MAX_ROW_BYTES): the widths of the
# models the port serves; longer rows take the CUDA-core kernels. Packed int4
# rows of at most half of it (D <= 1,024) take the tensor cores too, and in
# bin_gather bf16 rows of at most all of it (D <= 512).
TC_MAX_ROW_BYTES = 1024
GATHER_TC_RUN = 1  # (query, slot) pairs a bin_gather_tc job takes, in their own order
# the longest f32 row bin_gather's f32 tensor-core kernel takes, in floats: the
# widths of the models the port serves; longer rows take bin_gather_kernel
GATHER_F32_TC_MAX_DIM = 1024
# bin_gather's f32 route sorts its (query, slot) pairs by bin, so that one block
# reads a bin once for up to 32 of the queries that chose it, when there are at
# least this many pairs a bin of the corpus; below, each pair's bin is read on its
# own (bin_gather_f32_layout)
GATHER_F32_SORT_PAIRS_PER_BIN = 0.5


def _route(dtype: torch.dtype, row_bytes: int) -> str:
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.int8 and row_bytes <= TC_MAX_ROW_BYTES:
        return "tc"
    if dtype == torch.uint8 and row_bytes <= TC_MAX_ROW_BYTES // 2:
        return "tc"
    return "cuda_core"


def binmax_route(dtype: torch.dtype, row_bytes: int) -> str:
    """The kernel a CUDA call of :func:`binmax` launches: ``"tc"``
    (``binmax_tc_kernel``: int8 mma, a warp a bin of 128 contiguous rows,
    each block's queries staged once) for int8 rows of at most
    ``TC_MAX_ROW_BYTES`` and packed int4 rows of at most half of it (each
    packed step unpacked in registers into the s8 fragments of both halves
    of the row); ``"bf16"`` (``binmax_f32_kernel`` with bf16 rows through
    the register-tiled fma tile, widened in shared memory) for bf16;
    ``"cuda_core"`` for f32 (``binmax_f32_kernel``) and longer int8 and
    int4 rows (``binmax_kernel``, dp4a)."""
    return _route(dtype, row_bytes)


def binmax_strided_route(dtype: torch.dtype, row_bytes: int) -> str:
    """The kernel a CUDA call of :func:`binmax_strided` launches: ``"tc"``
    (``binmax_strided_tc_kernel``: int8 mma, each block's queries staged once
    and its tiles read once for up to 64 of them) for int8 rows of at most
    ``TC_MAX_ROW_BYTES`` and packed int4 rows of at most half of it;
    ``"bf16"`` (``binmax_strided_f32_kernel`` with bf16 rows) for bf16;
    ``"cuda_core"`` for f32 (``binmax_strided_f32_kernel``, the
    register-tiled fma tile) and longer int8 and int4 rows
    (``binmax_strided_kernel``, dp4a)."""
    return _route(dtype, row_bytes)


def bin_gather_route(dtype: torch.dtype, row_bytes: int) -> str:
    """The kernel a CUDA call of :func:`bin_gather` launches. The tensor-core
    kernels give each 16-row tile of a (query, bin slot) pair its own warp,
    and take every row type whose tile fits a warp's shared memory:

    - ``"tc"``: ``bin_gather_tc_kernel``, int8 mma, for int8 rows of at most
      ``TC_MAX_ROW_BYTES`` and packed int4 rows of at most half of it (each
      packed step unpacked in registers into the s8 fragments of both halves
      of the row, against the query staged once a warp).
    - ``"bf16_tc"``: ``bin_gather_bf16_tc_kernel``, for bf16 rows of at most
      ``TC_MAX_ROW_BYTES`` (D <= 512): the f32 query split exactly into three
      bf16 terms, one bf16 mma a 16-dim step, the f32-query function of the
      CUDA cores up to the summation order.
    - ``"f32_tc"``: ``bin_gather_f32_tc_kernel``, for f32 rows of at most
      ``GATHER_F32_TC_MAX_DIM`` floats: each product as three TF32
      products on mma.sync m16n8k8 (hi hi, lo hi, hi lo, f32 sums), the
      rows streamed through a ring of 32-float chunks, the pairs sorted by
      bin or in their own order (:func:`bin_gather_f32_layout`); counted in
      ``tc_launches`` and ``f32_tc_launches`` (``sorted_launches``: sorted).
    - ``"bf16"``: ``bin_gather_kernel`` in its bf16 mode, longer bf16 rows.
    - ``"cuda_core"``: ``bin_gather_kernel``, a block per pair, for longer
      f32, int8 and int4 rows.

    Why, on an H100 (tools/probe_gather.py, 1M x 384 rows, B * kb pairs):
    where one launch's latency is the time, the tensor-core kernels beat
    ``bin_gather_kernel`` (int8 0.0053 against 0.0080 ms in chip_smoke.py;
    int4 0.0048 against 0.0071, bf16 0.0080 against 0.0157 at B = 16, kb = 10;
    bf16 still 1.2x at 640 pairs); from about 640 pairs on, both read near
    the raw bytes' rate, within 7 % of each other either way (int4
    0.24-0.25 ms each at B = 256, kb = 100). So no batch or kb picks the
    route."""
    if dtype == torch.bfloat16 and row_bytes <= TC_MAX_ROW_BYTES:
        return "bf16_tc"
    if dtype == torch.float32 and row_bytes <= 4 * GATHER_F32_TC_MAX_DIM:
        return "f32_tc"
    return _route(dtype, row_bytes)


def bin_order(bins: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The (query, slot) pairs ``b * kb + s`` of ``bins [B, kb]`` (each bin
    below ceil(n_rows / 128)) sorted by bin, the pairs of one bin in their
    own order (int64 [B * kb]): one stable argsort, on 16-bit keys where
    every bin fits them (fewer radix passes)."""
    keys = bins.view(-1)
    if -(-n_rows // BIN_W) <= 2**15:
        keys = keys.to(torch.int16)
    return torch.argsort(keys, stable=True)


def bin_gather_f32_layout(n_pairs: int, n_rows: int) -> str:
    """How the f32 route lays out ``n_pairs`` (query, slot) pairs over a
    corpus of ``n_rows`` rows: ``"sorted"`` (the pairs sorted by bin,
    :func:`bin_order`, so that a block scores up to 32 queries of one bin
    against each tile it reads, the queries as the columns of the mma) from
    ``GATHER_F32_SORT_PAIRS_PER_BIN`` pairs a bin on, else ``"own"`` (a
    block of four warps half of one pair's bin, no sort).

    Why, on an H100 (tools/probe_gather_f32.py, device ms of the kernel
    and, sorted, of the sort, 1M x 384 rows unless said): at B = 256, 0.28
    pairs a bin (kb = 10), own 0.183 against sorted 0.218 + 0.028; at
    0.98 (kb = 30) 0.532 against 0.393 + 0.052; at 3.3 (kb = 100) 1.764
    against 0.636 + 0.055; the evaluator's 312 (B = 1,000, kb = 20 over
    8,192 rows) 0.741 against 0.099 + 0.053. Below a pair a bin the runs of
    a sorted block hold many bins of one query each, scored in turn, so the
    crossing lies between 0.28 and 0.98; at B <= 64, kb = 10 the pairs'
    own order wins 4-17x."""
    n_bins = -(-n_rows // BIN_W)
    return "sorted" if n_pairs >= GATHER_F32_SORT_PAIRS_PER_BIN * n_bins else "own"


def _mode(corpus: torch.Tensor) -> int:
    if corpus.dtype not in _MODES:
        raise TypeError(f"corpus dtype {corpus.dtype} not in float32 / bfloat16 / int8 / uint8")
    return _MODES[corpus.dtype]


def _check_operands(q_in, corpus, row_scales, valid_n):
    """Validate what both kernels read; returns (mode, row_words)."""
    mode = _mode(corpus)
    if q_in.dim() != 2 or corpus.dim() != 2:
        raise ValueError("queries and corpus must be 2-D")
    want_q = torch.int8 if mode in _QUANTIZED else torch.float32
    if q_in.dtype != want_q:
        raise TypeError(f"queries must be {want_q} for a {corpus.dtype} corpus")
    d, dc = q_in.shape[1], corpus.shape[1]
    if d != (2 * dc if mode == 2 else dc):
        raise ValueError(f"query dim {d} does not match corpus columns {dc}")
    if mode in _QUANTIZED and row_scales is None:
        raise ValueError("an int8 or int4 corpus requires row_scales")
    if row_scales is not None and (
        row_scales.dtype != torch.float32 or row_scales.shape != (corpus.shape[0],)
    ):
        raise ValueError("row_scales must be float32 [N]")
    if not 0 <= valid_n <= corpus.shape[0]:
        raise ValueError(f"valid_n {valid_n} outside [0, {corpus.shape[0]}]")
    row_bytes = dc * corpus.element_size()
    return mode, row_bytes // 4


def _check_cuda(*tensors):
    """The kernels take contiguous tensors on one CUDA device, 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _ptr(t):
    """A tensor's address for a ``c_void_p`` argument (ctypes takes the int
    or None as it is)."""
    return t.data_ptr() if t is not None else None


def _stream(device):
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``:
    ``torch.cuda.current_stream(device).cuda_stream`` without the Stream
    object it builds, which cost a launch-bound wrapper 3 us a call on the
    card's host (chip_smoke.py's ``bin_gather_host_us``). A C entry launches
    on the current device, so ``device`` must be it (the caller holds
    ``torch.cuda.device(device)``, as each shard of a sharded index does):
    a kernel never launches on another device than its tensors'."""
    _build.check_current_device(device)
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# Phase A
# ---------------------------------------------------------------------------


def binmax(q_in, corpus, row_scales=None, valid_n: int | None = None) -> torch.Tensor:
    """Bin maxima ``[ceil(N / 128), B]`` f32 of ``(corpus @ q_in.T) * row_scales``
    with rows ``>= valid_n`` at ``NEG_INF``. ``q_in``: f32 queries for an f32
    or bf16 corpus, int8 (quantized) queries for an int8 or packed-int4
    corpus; the query scale is left out, as it cannot change a query's order
    of bins."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    mode, row_words = _check_operands(q_in, corpus, row_scales, valid_n)
    if corpus.device.type == "cpu":
        return binmax_plain(q_in, corpus, row_scales, valid_n)
    if corpus.device.type != "cuda":
        raise ValueError(f"binmax runs on cuda or cpu, not {corpus.device}")
    if (row_words * 4) % 16:
        raise ValueError("binmax needs corpus rows of a multiple of 16 bytes")
    _check_cuda(q_in, corpus, row_scales)
    B = q_in.shape[0]
    out = torch.empty(((n + BIN_W - 1) // BIN_W, B), dtype=torch.float32, device=corpus.device)
    route = binmax_route(corpus.dtype, row_words * 4)
    if route == "tc":
        _build.check(
            _fn("binmax", "sskd_binmax_tc")(
                mode, _ptr(q_in), _ptr(corpus), _ptr(row_scales), _ptr(out),
                B, n, row_words * 4, valid_n, _stream(corpus.device),
            ),
            "binmax (tensor cores)",
        )
        binmax.launches += 1
        binmax.tc_launches += 1
        return out
    _build.check(
        _fn("binmax", "sskd_binmax")(
            mode, _ptr(q_in), _ptr(corpus), _ptr(row_scales), _ptr(out),
            B, n, row_words, valid_n, _stream(corpus.device),
        ),
        "binmax",
    )
    binmax.launches += 1
    binmax.bf16_launches += route == "bf16"
    return out


binmax.launches = 0
binmax.tc_launches = 0  # the launches that took the tensor-core route
binmax.bf16_launches = 0  # the launches that took the bf16 route


def _dense_rows(corpus: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` as f32 values (int4 unpacked); int values < 2^24 stay exact."""
    block = corpus[lo:hi]
    if block.dtype == torch.uint8:
        block = unpack_int4(block)
    return block.to(torch.float32)


def _scores_block(q, corpus, row_scales, lo, hi, valid_n):
    """Scaled, masked scores ``[hi - lo, B]`` of rows ``[lo, hi)``: an exact
    integer dot for int8 / int4, then the row scale, then the mask."""
    scores = _dense_rows(corpus, lo, hi) @ q.T
    if row_scales is not None:
        scores = scores * row_scales[lo:hi, None]
    rows = torch.arange(lo, hi, device=corpus.device)
    return torch.where((rows < valid_n)[:, None], scores, NEG_INF)


def binmax_plain(q_in, corpus, row_scales=None, valid_n: int | None = None) -> torch.Tensor:
    """Plain torch version of :func:`binmax` (same arithmetic: an exact
    integer dot for int8 / int4, then the row scale, the mask and the max)."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    q = q_in.to(torch.float32)
    parts = []
    for lo in range(0, n, _PLAIN_ROWS):  # _PLAIN_ROWS is a multiple of BIN_W
        hi = min(n, lo + _PLAIN_ROWS)
        scores = _scores_block(q, corpus, row_scales, lo, hi, valid_n)
        pad = -(hi - lo) % BIN_W
        if pad:
            scores = torch.cat([scores, scores.new_full((pad, q.shape[0]), NEG_INF)])
        parts.append(scores.view(-1, BIN_W, q.shape[0]).amax(dim=1))
    return torch.cat(parts)


def binmax_strided(q_in, corpus, row_scales=None, valid_n: int | None = None,
                   blocks: int = 1):
    """``(maxima, rows)``, each ``[blocks * 128, B]`` (f32, int32), of the
    scores of :func:`binmax` over strided bins: bin ``j * 128 + t`` holds the
    rows ``(j + i * blocks) * 128 + t`` for i = 0, 1, ..., so a bin's rows lie
    ``blocks * 128`` apart. ``rows`` names the row of each maximum, the lowest
    on a tie; a bin of no valid row gives ``NEG_INF`` and its first row."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    mode, row_words = _check_operands(q_in, corpus, row_scales, valid_n)
    if not 1 <= blocks <= (n + BIN_W - 1) // BIN_W:
        raise ValueError(f"blocks {blocks} outside [1, {(n + BIN_W - 1) // BIN_W}]")
    if corpus.device.type == "cpu":
        return binmax_strided_plain(q_in, corpus, row_scales, valid_n, blocks)
    if corpus.device.type != "cuda":
        raise ValueError(f"binmax_strided runs on cuda or cpu, not {corpus.device}")
    if (row_words * 4) % 16:
        raise ValueError("binmax_strided needs corpus rows of a multiple of 16 bytes")
    if n + BIN_W >= 2**31:
        raise ValueError("binmax_strided returns int32 rows: the corpus must have < 2^31 rows")
    _check_cuda(q_in, corpus, row_scales)
    B = q_in.shape[0]
    out = torch.empty((blocks * BIN_W, B), dtype=torch.float32, device=corpus.device)
    rows = torch.empty((blocks * BIN_W, B), dtype=torch.int32, device=corpus.device)
    route = binmax_strided_route(corpus.dtype, row_words * 4)
    if route == "tc":
        _build.check(
            _fn("binmax", "sskd_binmax_strided_tc")(
                mode, _ptr(q_in), _ptr(corpus), _ptr(row_scales), _ptr(out), _ptr(rows),
                B, n, row_words * 4, valid_n, blocks, _stream(corpus.device),
            ),
            "binmax_strided (tensor cores)",
        )
        binmax_strided.launches += 1
        binmax_strided.tc_launches += 1
        return out, rows
    _build.check(
        _fn("binmax", "sskd_binmax_strided")(
            mode, _ptr(q_in), _ptr(corpus), _ptr(row_scales), _ptr(out), _ptr(rows),
            B, n, row_words, valid_n, blocks, _stream(corpus.device),
        ),
        "binmax_strided",
    )
    binmax_strided.launches += 1
    binmax_strided.bf16_launches += route == "bf16"
    return out, rows


binmax_strided.launches = 0
binmax_strided.tc_launches = 0  # the launches that took the tensor-core route
binmax_strided.bf16_launches = 0  # the launches that took the bf16 route


def binmax_strided_plain(q_in, corpus, row_scales=None, valid_n: int | None = None,
                         blocks: int = 1):
    """Plain torch version of :func:`binmax_strided`: the scores a chunk of
    rows at a time (whole rounds of ``blocks`` tiles), the best of each round
    with its first row, and a running best that a later round replaces only
    when it is strictly greater."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    q = q_in.to(torch.float32)
    B, dev = q.shape[0], corpus.device
    span = blocks * BIN_W  # rows of one round of tiles
    rounds = max(1, _PLAIN_ROWS // span)
    best = torch.full((span, B), NEG_INF, dtype=torch.float32, device=dev)
    first = torch.arange(span, device=dev)[:, None]  # each bin's first row
    rows = first.expand(span, B).clone()
    for lo in range(0, n, rounds * span):
        hi = min(n, lo + rounds * span)
        scores = _scores_block(q, corpus, row_scales, lo, hi, valid_n)
        r = -(-(hi - lo) // span)
        pad = r * span - (hi - lo)
        if pad:
            scores = torch.cat([scores, scores.new_full((pad, B), NEG_INF)])
        scores = scores.view(r, span, B)
        top = scores.amax(dim=0)
        step = torch.arange(r, device=dev)[:, None, None]
        first_round = torch.where(scores == top, step, r).amin(dim=0)  # [span, B]
        better = top > best
        best = torch.where(better, top, best)
        rows = torch.where(better, lo + first_round * span + first, rows)
    return best, rows.to(torch.int32)


# ---------------------------------------------------------------------------
# Phase B
# ---------------------------------------------------------------------------


def bin_gather(q_in, q_scale, corpus, row_scales, bins, valid_n: int | None = None):
    """Exact scores ``[B, kb, 128]`` of the rows of bins ``bins [B, kb]``
    (int32, each < ceil(N / 128)): ``dot * q_scale[b] * row_scale`` for int8 /
    int4, ``dot * row_scale`` (scale optional) for f32 and bf16 rows (f32
    queries); rows ``>= valid_n`` at ``NEG_INF``."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    mode, row_words = _check_operands(q_in, corpus, row_scales, valid_n)
    B, kb = bins.shape
    if bins.dtype != torch.int32 or B != q_in.shape[0]:
        raise ValueError("bins must be int32 [B, kb]")
    quantized = mode in _QUANTIZED
    if quantized and (q_scale is None or q_scale.shape != (B,) or q_scale.dtype != torch.float32):
        raise ValueError("int8 / int4 corpora need q_scale float32 [B]")
    if corpus.device.type == "cpu":
        return bin_gather_plain(q_in, q_scale, corpus, row_scales, bins, valid_n)
    if corpus.device.type != "cuda":
        raise ValueError(f"bin_gather runs on cuda or cpu, not {corpus.device}")
    if (row_words * 4) % 16:
        raise ValueError("bin_gather needs corpus rows of a multiple of 16 bytes")
    _check_cuda(q_in, corpus, row_scales, bins, q_scale if quantized else None)
    out = torch.empty((B, kb, BIN_W), dtype=torch.float32, device=corpus.device)
    route = bin_gather_route(corpus.dtype, row_words * 4)
    if route == "f32_tc":
        sort = bin_gather_f32_layout(B * kb, n) == "sorted"
        order = bin_order(bins, n) if sort else None
        _build.check(
            _fn("bin_gather", "sskd_bin_gather_f32_tc")(
                _ptr(q_in), _ptr(corpus), _ptr(row_scales), _ptr(bins), _ptr(order), _ptr(out),
                B, kb, n, corpus.shape[1], valid_n, _stream(corpus.device),
            ),
            "bin_gather (f32, tensor cores)",
        )
        bin_gather.launches += 1
        bin_gather.tc_launches += 1
        bin_gather.f32_tc_launches += 1
        bin_gather.sorted_launches += sort
        return out
    if route in ("tc", "bf16_tc"):
        # the pairs in their own order (order NULL), one a job: no sort
        _build.check(
            _fn("bin_gather", "sskd_bin_gather_tc")(
                mode, _ptr(q_in), _ptr(q_scale if quantized else None), _ptr(corpus),
                _ptr(row_scales), _ptr(bins), None, _ptr(out), B, kb, n, row_words * 4,
                valid_n, GATHER_TC_RUN, _stream(corpus.device),
            ),
            "bin_gather (tensor cores)",
        )
        bin_gather.launches += 1
        bin_gather.tc_launches += 1
        bin_gather.bf16_launches += route == "bf16_tc"
        return out
    _build.check(
        _fn("bin_gather", "sskd_bin_gather")(
            mode, _ptr(q_in), _ptr(q_scale if quantized else None), _ptr(corpus),
            _ptr(row_scales), _ptr(bins), _ptr(out), B, kb, n, row_words, valid_n,
            _stream(corpus.device),
        ),
        "bin_gather",
    )
    bin_gather.launches += 1
    bin_gather.bf16_launches += route == "bf16"
    return out


bin_gather.launches = 0
bin_gather.tc_launches = 0  # the launches that took a tensor-core route ("tc", "bf16_tc", "f32_tc")
bin_gather.bf16_launches = 0  # the launches over bf16 rows ("bf16_tc", "bf16")
bin_gather.f32_tc_launches = 0  # the launches over f32 rows on the tensor cores ("f32_tc")
bin_gather.sorted_launches = 0  # of them, those over pairs sorted by bin


def bin_gather_plain(q_in, q_scale, corpus, row_scales, bins, valid_n: int | None = None):
    """Plain torch version of :func:`bin_gather`, one query at a time."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    B, kb = bins.shape
    lane = torch.arange(BIN_W, device=corpus.device)
    quantized = corpus.dtype in (torch.int8, torch.uint8)
    out = []
    for b in range(B):
        rows = (bins[b].to(torch.int64)[:, None] * BIN_W + lane).reshape(-1)
        safe = rows.clamp(max=n - 1)
        dense = corpus[safe]
        dense = (unpack_int4(dense) if corpus.dtype == torch.uint8 else dense).to(torch.float32)
        s = dense @ q_in[b].to(torch.float32)
        if quantized:
            s = s * q_scale[b] * row_scales[safe]
        elif row_scales is not None:
            s = s * row_scales[safe]
        out.append(torch.where(rows < valid_n, s, NEG_INF).view(kb, BIN_W))
    return torch.stack(out)


_ARGTYPES = {
    "sskd_binmax": "i p p p p i l i l p",
    "sskd_binmax_tc": "i p p p p i l i l p",
    "sskd_binmax_strided": "i p p p p p i l i l i p",
    "sskd_binmax_strided_tc": "i p p p p p i l i l i p",
    "sskd_bin_gather": "i p p p p p p i i l i l p",
    "sskd_bin_gather_tc": "i p p p p p p p i i l i l i p",
    "sskd_bin_gather_f32_tc": "p p p p p p i i l i l p",
    "sskd_cell_gather": "i p p p p p p p i i i i p",
    "sskd_cell_gather_b1": "i p p p p p i i i p",
    "sskd_cell_gather_tc": "p p p p p p p i i i i p",
}
_CTYPES = {"i": ctypes.c_int, "l": ctypes.c_long, "p": ctypes.c_void_p}


@functools.lru_cache(maxsize=None)
def _fn(stem: str, name: str):
    """C entry point ``name`` of the library built from ``csrc/<stem>.cu``,
    with its signature declared."""
    fn = getattr(_build.load_library(stem), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[c] for c in _ARGTYPES[name].split()]
    return fn


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def topk_stable(x: torch.Tensor, k: int):
    """Top-k over the last axis, ties broken toward the lower index (as
    ``lax.top_k`` does), so that both packages return the same ids."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def quantize_queries(queries: torch.Tensor, corpus: torch.Tensor):
    """The engine's query operand: f32 queries for an f32 or bf16 corpus (the
    TPU kernels take a bf16 corpus against the f32 query); int8 queries and
    their f32 scales [B] for an int8 or int4 corpus."""
    if corpus.dtype in (torch.float32, torch.bfloat16):
        return queries.to(torch.float32).contiguous(), None
    q_in, q_scale = quantize_rows(queries)
    return q_in.contiguous(), q_scale.contiguous()


def cosine_topk_kernels(queries, corpus, k: int, row_scales=None, valid_n: int | None = None):
    """Exact top-k through ``binmax`` and ``bin_gather``: same contract as
    :func:`sskd_tpu_torch.ops.topk.cosine_topk`. ``corpus`` [N, D] f32, bf16
    or int8, or [N, D/2] uint8 packed int4 (``row_scales`` [N] required for
    the quantized forms)."""
    if k > K_MAX:
        raise ValueError(f"k={k} exceeds kernel capacity {K_MAX}")
    if corpus.dtype == torch.uint8 and corpus.shape[1] * 2 != queries.shape[1]:
        raise ValueError(
            f"packed int4 corpus cols {corpus.shape[1]} != query dim {queries.shape[1]} / 2"
        )
    B = queries.shape[0]
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    q_in, q_scale = quantize_queries(queries, corpus)

    bin_max = binmax(q_in, corpus, row_scales, valid_n)  # [n_bins, B]
    n_bins = bin_max.shape[0]
    kb = min(k, n_bins)
    bin_vals, bin_ids = topk_stable(bin_max.T, kb)  # [B, kb]
    slot_ok = bin_vals > NEG_INF / 2  # dead slots: bins holding no valid row
    bins = bin_ids.to(torch.int32).contiguous()

    gathered = bin_gather(q_in, q_scale, corpus, row_scales, bins, valid_n)
    cand = torch.where(slot_ok[:, :, None], gathered, NEG_INF).reshape(B, kb * BIN_W)
    lane = torch.arange(BIN_W, device=corpus.device, dtype=torch.int32)
    cand_idx = (bins[:, :, None] * BIN_W + lane).reshape(B, kb * BIN_W)
    k_top = min(k, kb * BIN_W)
    vals, pos = topk_stable(cand, k_top)
    idx = torch.gather(cand_idx, 1, pos)
    if k_top < k:  # pad out to the requested k
        vals = torch.cat([vals, vals.new_full((B, k - k_top), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, k - k_top), -1)], dim=1)
    idx = torch.where(vals > NEG_INF / 2, idx, -1)
    return vals, idx
