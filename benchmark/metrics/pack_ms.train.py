"""Host milliseconds to pack one batch (``KDDataset.batches``: tokenize and
pad), the mean over the window; it runs in the trainer's prefetch
thread."""

from benchmark.harness.readers import mean_ms


def read(run, entry, trace):
    return mean_ms(run, "pack")
