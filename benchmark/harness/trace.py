"""The traced window: ``torch.profiler`` over whole calls, and what its
trace says.

An entry calls :meth:`Tracer.boundary` between two calls into the program,
in the thread that runs them, and :meth:`Tracer.stop` in the same thread
once the measured window has closed. The first boundary in the window's last
``seconds`` waits for the device and starts the profiler; the stop waits for
the device again, so the traced window holds whole calls and all their
device work, and the profiler's own wind-down falls outside the window. The trace is read from
its Chrome export: every kernel, copy and set on the device, the runtime
call that launched it, and the host ranges (``bench.*`` and PyTorch's own
operators) open on the launching thread at that moment.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96


@dataclass
class DeviceOp:
    name: str
    start: float  # us, the trace's clock
    dur: float  # us
    ranges: tuple = ()  # bench.* ranges open at launch, outermost first
    ops: tuple = ()  # PyTorch operators open at launch


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)
    gaps: list = field(default_factory=list)  # (seconds, host range at the gap)
    events_outside: int = 0  # device events outside the window's host span

    def select(self, pattern) -> list[DeviceOp]:
        return [op for op in self.ops if pattern.search(op.name)]

    def breakdown(self) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:NAME_CHARS]] += op.dur * 1e-6
        by_gap: dict[str, float] = defaultdict(float)
        for seconds, label in self.gaps:
            by_gap[label] += seconds
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


class Tracer:
    def __init__(self, recorder, enabled: bool, seconds: float):
        self.recorder = recorder
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.window_range = None
        self.t_start = None  # when the profiler started, inside the window
        self.done = False
        self.trace: Trace | None = None

    def prime(self) -> None:
        """Start and stop the profiler once, so that its first start (which
        sets up the device's tracing) falls in set-up, not in the window."""
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def boundary(self) -> None:
        """Start the profiler at the first call boundary of the window's last
        ``seconds``; it runs on to the window's close, so that stopping it
        and gathering its events falls outside the window."""
        if (not self.enabled or self.prof is not None or not self.recorder.window_open
                or time.perf_counter() < self.recorder.deadline - self.seconds):
            return
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.window_range = torch.profiler.record_function("bench.trace_window")
        self.window_range.__enter__()
        self.recorder.tracing = True
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.recorder.tracing = False
        self.window_range.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def read(self) -> Trace | None:
        """The trace of the window (None when no window was traced)."""
        if self.prof is None:
            return None
        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.trace = parse(events)
        return self.trace


def _stack_sweep(intervals: list[tuple], queries: list[tuple]) -> dict:
    """For nested ``intervals`` (start, end, name) of one thread and
    ``queries`` (time, key), the names open at each query's time, outermost
    first, by key."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    queries = sorted(queries)
    out, stack, i = {}, [], 0
    for t, key in queries:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = tuple(iv[2] for iv in stack if iv[1] >= t)
    return out


def parse(events: list[dict]) -> Trace:
    window = next((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == "bench.trace_window"), None)
    if window is None:
        raise RuntimeError("the trace holds no bench.trace_window range")
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    launches, ranges, ops = {}, defaultdict(list), defaultdict(list)
    device = []
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat == "user_annotation" and e["name"].startswith("bench.") \
                and e["name"] != "bench.trace_window":
            ranges[e.get("tid")].append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            ops[e.get("tid")].append((ts, ts + dur, e["name"]))
    queries = defaultdict(list)
    for n, e in enumerate(device):
        hit = launches.get(e.get("args", {}).get("correlation"))
        if hit is not None:
            queries[hit[0]].append((hit[1], n))
    open_ranges, open_ops = {}, {}
    for tid, qs in queries.items():
        open_ranges.update(_stack_sweep(ranges.get(tid, []), qs))
        open_ops.update(_stack_sweep(ops.get(tid, []), qs))
    trace = Trace(window_s=(w1 - w0) * 1e-6, busy_s=0.0)
    spans = []
    for n, e in enumerate(device):
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts < w0 or ts + dur > w1 + 1.0:
            trace.events_outside += 1
            continue
        trace.ops.append(DeviceOp(e["name"], ts, dur, open_ranges.get(n, ()), open_ops.get(n, ())))
        spans.append((ts, ts + dur))
    spans.sort()
    busy, cur0, cur1, gaps = 0.0, None, None, []
    edge = w0
    for a, b in spans:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            gaps.append((edge, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        edge = cur1
    if cur1 is not None:
        busy += cur1 - cur0
    gaps.append((edge, w1))
    trace.busy_s = busy * 1e-6
    trace.gaps = _label_gaps([(a, b) for a, b in gaps if b > a], ranges)
    return trace


def _label_gaps(gaps, ranges) -> list[tuple[float, str]]:
    """Each idle gap's seconds and the innermost ``bench.*`` range open at
    its middle, on the thread with the deepest stack of them."""
    mids = [((a + b) / 2, n) for n, (a, b) in enumerate(gaps)]
    best: dict[int, tuple] = {}
    for ivs in ranges.values():
        for n, names in _stack_sweep(ivs, mids).items():
            if names and len(names) > len(best.get(n, ())):
                best[n] = names
    out = []
    for n, (a, b) in enumerate(gaps):
        label = best[n][-1].split(" ")[0] if n in best else "no benchmark range"
        out.append(((b - a) * 1e-6, label))
    return out


def ops_under(trace: Trace, range_prefix: str) -> list[DeviceOp]:
    """Device ops launched inside a ``bench.<range_prefix>...`` range."""
    return [op for op in trace.ops if any(r.startswith(range_prefix) for r in op.ranges)]
