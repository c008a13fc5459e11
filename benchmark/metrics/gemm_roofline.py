"""Share of the dense layers' roofline: the FLOPs of every traced forward's
matrix products over its padded array (and the cross-encoder's head), at
the configuration dtype's peak, over the device time of the kernels that
``aten::linear`` launched."""

from benchmark import roofline
from benchmark.harness.readers import dtype, share


def read(run, entry, trace):
    calls = run.recorder.traced("forward")
    if trace is None or not calls:
        return None
    a = entry.arch
    cross = getattr(entry, "cross_encoder", False)
    flops = sum(roofline.gemm_flops(c["B"], c["L"], a.hidden, a.intermediate, a.layers)
                + (roofline.head_flops(c["B"], a.hidden) if cross else 0.0) for c in calls)
    ops = [op for op in trace.ops if "aten::linear" in op.ops]
    return share(flops / roofline.PEAK_OPS[dtype(entry)], ops)
