"""Rows a micro-batch holds: the mean ``batch`` of the program's
``index_search`` spans that began inside the window (its ring buffer keeps
the last 2,048)."""

import numpy as np


def read(run, entry, trace):
    rows = [s.attributes.get("batch") for s in entry.spans if "batch" in s.attributes]
    return float(np.mean(rows)) if rows else None
