"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, and the result line.

An entry (``benchmark/entries/<entry>.py``, named by the traffic file) is a
class ``Entry(run)`` with:

- ``setup()``: load the program's objects from the seed and warm up every
  shape the cell's traffic reaches;
- ``window()``: drive the program for the run's seconds, calling
  ``run.open_window()`` when the measured window opens and
  ``run.close_window()`` when it closes, and ``run.tracer.boundary()``
  between two calls into the program;
- ``end_to_end()``: the cell's end-to-end metrics by name;
- ``release()``: free the program's state on the device;
- ``check()``: the numbers compared with the reference, by name;
- ``attempted`` and ``failed``: the units of work tried and failed.

A per-layer metric is read by ``benchmark/metrics/<name>.py``, whose
``read(run, entry, trace)`` returns a number, or None where the run has
nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark.harness.record import Recorder
from benchmark.harness.spec import BENCH, Cell
from benchmark.harness.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "sskd_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_class(name: str):
    return _load(BENCH / "entries" / f"{name}.py", f"bench_entry_{name}").Entry


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    return _load(path, "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    device: str
    trace: bool
    t0: float
    recorder: Recorder = field(default_factory=Recorder)
    tracer: Tracer | None = None
    setup_s: float | None = None
    window_t0: float | None = None
    window_t1: float | None = None

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def open_window(self) -> None:
        self.sync()
        self.window_t0 = time.perf_counter()
        self.setup_s = self.window_t0 - self.t0
        self.recorder.deadline = self.deadline
        self.recorder.window_open = True

    def close_window(self) -> None:
        self.sync()
        self.window_t1 = time.perf_counter()
        self.recorder.window_open = False

    @property
    def window_s(self) -> float:
        return self.window_t1 - self.window_t0

    @property
    def deadline(self) -> float:
        return self.window_t0 + self.seconds

    @property
    def untraced_s(self) -> float:
        """Seconds of the window before the profiler started."""
        start = self.tracer.t_start if self.tracer.t_start is not None else self.window_t1
        return min(start, self.window_t1) - self.window_t0


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: dict | None = None
    readings: dict = field(default_factory=dict)  # numbers read but held to no limit
    trace_events_outside: int = 0  # device events of the trace outside its window

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None) -> Result:
    run = Run(cell, seed, seconds, device, trace, t0 if t0 is not None else time.perf_counter())
    run.tracer = Tracer(run.recorder, trace and run.cuda, cell.traffic.get("trace_seconds", 3.0))
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    entry = entry_class(cell.traffic["entry"])(run)
    entry.setup()
    run.tracer.prime()
    entry.window()
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    traced = run.tracer.read() if trace else None
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run, entry, traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = entry.end_to_end()
        values["setup_s"] = run.setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    entry.release()
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    numbers = entry.check()
    checks, correct = {}, entry.failed == 0
    for name in cell.limits:
        value, limit = numbers[name], cell.limits[name]
        correct = correct and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
           "count": cell.chips if run.cuda else 0,
           "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
    readings = {k: v for k, v in numbers.items() if k not in checks}
    return Result(correct, int(entry.attempted), int(entry.failed), metrics, dev, checks,
                  traced.breakdown() if traced is not None else None, readings,
                  traced.events_outside if traced is not None else 0)
