"""Host milliseconds of one ``StudentModel.forward_batch`` call (the query
encode's launches; the device runs on), the mean over the window."""

from benchmark.harness.readers import mean_ms


def read(run, entry, trace):
    return mean_ms(run, "forward")
