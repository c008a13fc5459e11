"""Share of the traced window in which no kernel, copy or set ran on the
device."""

from benchmark.harness.readers import idle_share


def read(run, entry, trace):
    return idle_share(trace)
