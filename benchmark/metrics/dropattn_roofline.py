"""Share of the dropout-attention pair's roofline: for each traced step, the
forward and backward of every layer of both towers (bytes and operations
from the shapes), over the device time of the ``dropattn`` kernels. The
forward that recomputation runs again is not counted as needed work."""

import re

from benchmark import roofline
from benchmark.harness.readers import dtype, share

KERNELS = re.compile(r"dropattn")


def read(run, entry, trace):
    steps = run.recorder.traced("step")
    if trace is None or not steps:
        return None
    a, dt = entry.arch, dtype(entry)
    bound = 0.0
    for c in steps:
        for rows, length in ((c["q_rows"], c["q_len"]), (c["d_rows"], c["d_len"])):
            bh = rows * a.heads
            bound += a.layers * (
                roofline.bound_s(*roofline.attention_fwd_work(bh, length, a.head_dim, dt), dt)
                + roofline.bound_s(*roofline.attention_bwd_work(bh, length, a.head_dim, dt), dt))
    return share(bound, trace.select(KERNELS))
