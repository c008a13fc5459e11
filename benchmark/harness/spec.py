"""A cell's description, found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file and its limits file.

- ``benchmark/configs/<config>.json``: the model as published (the keys of
  its ``config.json``), the dtype it computes in, ``reduced`` and ``assumed``.
- ``benchmark/traffic/<traffic>.json``: the parameters of one traffic mix,
  and in ``entry`` the module under ``benchmark/entries/`` that runs it.
- ``benchmark/limits/<workload>.json``: the limit of each number the cell's
  comparison reads.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e,
        per_layer=per_layer,
    )
