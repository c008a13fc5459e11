"""The whole step's share of the card: three times the forward FLOPs of the
real tokens of the steps in the window (forward and backward; the forward
that recomputation runs again is not needed work), at the configuration
dtype's peak, over the window (the calls and seconds while the profiler was
off)."""

import numpy as np

from benchmark import roofline
from benchmark.harness.readers import dtype, sequence_flops


def read(run, entry, trace):
    steps = run.recorder.in_window("step")
    if not steps:
        return None
    flops = sum(sequence_flops(np.concatenate([c["q_lengths"], c["d_lengths"]]), entry.arch,
                               False) for c in steps)
    return 100.0 * 3.0 * flops / roofline.PEAK_OPS[dtype(entry)] / run.untraced_s
