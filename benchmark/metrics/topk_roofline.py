"""Share of the exact sweep's roofline: for each traced micro-batch, one
pass over the index (each int8 row and its scale read once, 2 B N D integer
operations at the padded batch B), over the device time of the sweep's
kernels (``binmax``, ``bin_gather``)."""

import re

from benchmark import roofline
from benchmark.harness.readers import share

KERNELS = re.compile(r"binmax|bin_gather")


def read(run, entry, trace):
    calls = run.recorder.traced("topk")
    if trace is None or not calls:
        return None
    bound = sum(roofline.bound_s(*roofline.sweep_work(entry.rows, entry.arch.hidden, c["B"]),
                                 "int8") for c in calls)
    return share(bound, trace.select(KERNELS))
