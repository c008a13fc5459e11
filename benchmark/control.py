"""The comparison's control: the plain reference put in the program's place,
computed a precision below the configuration's (float8 e4m3 products for a
bfloat16 configuration, TF32 products for a float32 one), and read by the
same numbers as the program. The control has to come out as not correct;
its readings set the upper end of each limit.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --seconds 3

runs, for each seed, the cell's set-up and a short window at the cell's own
size and load, then prints one JSON line with the program's numbers, the
control's and, for a training cell, those of the faults a step can have
(read with the reference in the program's place). The benchmark's own runs
never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    import torch

    from benchmark.harness.core import Run, entry_class
    from benchmark.harness.trace import Tracer

    run = Run(cell, seed, seconds, device, False, time.perf_counter())
    run.tracer = Tracer(run.recorder, False, 0.0)
    entry = entry_class(cell.traffic["entry"])(run)
    entry.setup()
    entry.window()
    entry.release()
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    precision = LOWER[cell.config["compute_dtype"]]
    out = {"seed": seed, "program": entry.check(), "control": entry.control(precision),
           "precision": precision}
    if hasattr(entry, "faults"):
        out["faults"] = entry.faults()
    if hasattr(entry, "worst"):
        out["worst_leaves"] = entry.worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import load_cell

    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(load_cell(args.workload, ROOT), seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
