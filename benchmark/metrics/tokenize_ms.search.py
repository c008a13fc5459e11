"""Host milliseconds of one ``StudentModel.tokenize_batch`` call (a
micro-batch's queries), the mean over the window."""

from benchmark.harness.readers import mean_ms


def read(run, entry, trace):
    return mean_ms(run, "tokenize")
