"""Device milliseconds of the kernels launched inside the top-k call of one
micro-batch (``FusedSearcher._topk``), the mean over the traced batches."""

from benchmark.harness.readers import kernel_seconds
from benchmark.harness.trace import ops_under


def read(run, entry, trace):
    calls = run.recorder.traced("topk")
    if trace is None or not calls:
        return None
    return 1e3 * kernel_seconds(ops_under(trace, "bench.topk")) / len(calls)
