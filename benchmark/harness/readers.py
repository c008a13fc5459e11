"""What the per-layer readers share: host-clock means, the device's idle
share, roofline shares of kernels picked by name, and each forward's work."""

from __future__ import annotations

import re

import numpy as np

from benchmark import roofline

FORWARD = re.compile(r"forward B=(\d+) L=(\d+)")


def mean_ms(run, name: str) -> float | None:
    calls = run.recorder.in_window(name)
    if not calls:
        return None
    return 1e3 * float(np.mean([c["s"] for c in calls]))


def idle_share(trace) -> float | None:
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def kernel_seconds(ops) -> float:
    return sum(op.dur for op in ops) * 1e-6


def share(bound_s: float, ops) -> float | None:
    """A roofline share in percent; None where no kernel ran."""
    t = kernel_seconds(ops)
    if not ops or t <= 0:
        return None
    return 100.0 * bound_s / t


def forward_shape(op) -> tuple[int, int] | None:
    """(rows, length) of the forward whose range launched ``op``."""
    for r in op.ranges:
        m = FORWARD.match(r[len("bench."):])
        if m:
            return int(m.group(1)), int(m.group(2))
    return None


def sequence_flops(lengths, arch, cross_encoder: bool) -> float:
    """Forward FLOPs of sequences of these real lengths, each at its own."""
    lengths = np.asarray(lengths, np.float64)
    per_token = roofline.dense_flops_per_token(arch.hidden, arch.intermediate, arch.layers)
    total = float(lengths.sum() * per_token
                  + (4.0 * arch.layers * arch.hidden * lengths ** 2).sum())
    if cross_encoder:
        total += roofline.head_flops(len(lengths), arch.hidden)
    return total


def dtype(entry) -> str:
    return entry.cfg["compute_dtype"]
