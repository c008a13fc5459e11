"""Padded slots over all slots of the arrays handed to ``forward_batch`` in
the window: what the bucket ladder spends on padding."""


def read(run, entry, trace):
    calls = run.recorder.in_window("forward")
    slots = sum(c["B"] * c["L"] for c in calls)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(c["real"] for c in calls) / slots)
