"""The whole step's share of the card: the FLOPs of the real tokens through
the encoder (each sequence at its own length, the cross-encoder's head
included) handed to ``forward_batch`` in the window, at the configuration
dtype's peak, over the window (the calls and seconds while the profiler was
off)."""

from benchmark import roofline
from benchmark.harness.readers import dtype, sequence_flops


def read(run, entry, trace):
    calls = run.recorder.in_window("forward")
    if not calls:
        return None
    cross = getattr(entry, "cross_encoder", False)
    flops = sum(sequence_flops(c["lengths"], entry.arch, cross) for c in calls)
    return 100.0 * flops / roofline.PEAK_OPS[dtype(entry)] / run.untraced_s
