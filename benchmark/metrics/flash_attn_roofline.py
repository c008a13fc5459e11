"""Share of the flash attention kernel's roofline: each traced launch's
bytes (q, k, v and the output once, the key mask) and operations (Q K^T and
P V) from the shape of the forward that launched it, over the launches'
device time. None where no forward reached the kernel."""

import re

from benchmark import roofline
from benchmark.harness.readers import dtype, forward_shape, share

KERNELS = re.compile(r"flash_fwd")


def read(run, entry, trace):
    if trace is None:
        return None
    ops = trace.select(KERNELS)
    a = entry.arch
    bound = 0.0
    for op in ops:
        shape = forward_shape(op)
        if shape is None:
            return None
        bound += roofline.bound_s(
            *roofline.attention_fwd_work(shape[0] * a.heads, shape[1], a.head_dim, dtype(entry)),
            dtype(entry))
    return share(bound, ops)
