"""The benchmark's own spans around the calls into the program's layers.

:meth:`Recorder.wrap` replaces a method of one object by a wrapper that
records the host seconds of each call and what the call was handed, and,
while the profiler is on, names the call's range ``bench.<name>`` in the
trace (with the shape it was handed, where the entry gives one), so that
the device's kernels can be traced back to the layer that launched them.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Recorder:
    def __init__(self):
        self.calls: dict[str, list[dict]] = defaultdict(list)
        self.window_open = False
        self.deadline = float("inf")  # when the measured window is due to close
        self.tracing = False  # set by the tracer while its window is open
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, label: str | None = None, **info):
        """Times a block as one call of ``name``; ``label`` names its range in
        the trace (``bench.<name>`` by default)."""
        rf = None
        if self.tracing:
            rf = torch.profiler.record_function(f"bench.{label or name}")
            rf.__enter__()
        in_window = self.window_open
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            s = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            info.update(t=t0, s=s, window=in_window, traced=rf is not None)
            with self._lock:
                self.calls[name].append(info)

    def wrap(self, obj, attr: str, name: str, describe=None) -> None:
        """Record every call of ``obj.attr`` as ``name``. ``describe(*args,
        **kwargs)`` returns ``(label, info)``: the range's name in the trace
        and what to keep of the call, or None for neither."""
        fn = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            label, info = describe(*args, **kwargs) if describe else (None, {})
            with self.span(name, label, **info):
                return fn(*args, **kwargs)

        setattr(obj, attr, wrapper)

    def in_window(self, name: str) -> list[dict]:
        """Calls begun inside the measured window while the profiler was off
        (a traced call runs slower)."""
        return [c for c in self.calls.get(name, []) if c["window"] and not c["traced"]]

    def traced(self, name: str) -> list[dict]:
        return [c for c in self.calls.get(name, []) if c["traced"]]
