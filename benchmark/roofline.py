"""Published peaks of one NVIDIA H100 and the work that inputs need.

Every count here is computed from shapes: the operations and bytes that the
inputs need, whatever implements them. A kernel's roofline time is the larger
of its operations over the peak and its bytes over the memory bandwidth.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W. TF32 is the fastest rate at which the tensor cores take
f32 inputs, so it is the peak of the f32 configuration: no implementation of
f32 arithmetic can read above it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {
    "bfloat16": 989e12,
    "float32": 495e12,  # TF32 tensor cores
    "int8": 1979e12,
}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "int8": 1}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """Least seconds the card could take for ``n_ops`` operations at the
    peak of ``dtype`` and ``n_bytes`` at the memory bandwidth."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype])


def dense_flops_per_token(hidden: int, intermediate: int, layers: int) -> float:
    """The products of one token through the encoder's dense layers: four
    ``hidden x hidden`` projections and the two FFN matrices a layer."""
    return 2.0 * layers * (4 * hidden * hidden + 2 * hidden * intermediate)


def attention_flops(n: int, hidden: int, layers: int) -> float:
    """Scores and the weighted sum of one sequence of ``n`` tokens: ``Q K^T``
    and ``P V``, each ``2 n^2 hidden`` over all heads, a layer."""
    return 4.0 * layers * n * n * hidden


def encoder_flops(n: int, hidden: int, intermediate: int, layers: int) -> float:
    """Forward FLOPs of one sequence of ``n`` real tokens (no padding)."""
    return n * dense_flops_per_token(hidden, intermediate, layers) + attention_flops(
        n, hidden, layers)


def head_flops(batch: int, hidden: int) -> float:
    """The cross-encoder's pooler (``hidden x hidden``) and classifier."""
    return 2.0 * batch * hidden * (hidden + 1)


def gemm_flops(batch: int, length: int, hidden: int, intermediate: int, layers: int) -> float:
    """FLOPs of the dense layers over a ``[batch, length]`` array, padding
    included: what those matrix products are handed."""
    return batch * length * dense_flops_per_token(hidden, intermediate, layers)


def attention_fwd_work(bh: int, length: int, head_dim: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one attention forward over ``bh`` heads:
    q, k, v read and the output written once, the key mask read once a
    row of heads; ``Q K^T`` and ``P V``."""
    elt = DTYPE_BYTES[dtype]
    n_bytes = 4.0 * bh * length * head_dim * elt + bh * length * 4
    return n_bytes, 4.0 * bh * length * length * head_dim


def attention_bwd_work(bh: int, length: int, head_dim: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one attention backward: q, k, v, the output's
    gradient and the row statistics read, dq, dk, dv written; ``Q K^T``
    again, then dV, dP, dQ and dK."""
    elt = DTYPE_BYTES[dtype]
    n_bytes = 7.0 * bh * length * head_dim * elt + 2.0 * bh * length * 4
    return n_bytes, 10.0 * bh * length * length * head_dim


def sweep_work(rows: int, dim: int, queries: int) -> tuple[float, float]:
    """(bytes, operations) of one exact sweep of an int8 index: each row and
    its f32 scale read once, ``2 queries rows dim`` integer operations."""
    return float(rows) * dim + 4.0 * rows, 2.0 * queries * rows * dim
