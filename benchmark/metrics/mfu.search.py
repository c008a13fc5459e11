"""The whole step's share of the card: for each micro-batch of the window,
the roofline time of the work it needs (the real query tokens through the
encoder at the configuration's peak, and one sweep of the index for its
queries), summed and divided by the window (the calls and seconds
while the profiler was off)."""

from benchmark import roofline
from benchmark.harness.readers import dtype, sequence_flops


def read(run, entry, trace):
    calls = run.recorder.in_window("batch")
    if not calls:
        return None
    peak = roofline.PEAK_OPS[dtype(entry)]
    work = sum(sequence_flops(c["tokens"], entry.arch, False) / peak
               + roofline.bound_s(*roofline.sweep_work(entry.rows, entry.arch.hidden,
                                                       len(c["tokens"])), "int8")
               for c in calls)
    return 100.0 * work / run.untraced_s
