"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the entry of ``--workload`` in ``BENCHMARK.json`` at the root of
the checkout. Without as many CUDA devices as the cell asks for, or without
the program beside the benchmark, it exits with a code other than 0 and
prints no result. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end metrics,
or with ``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, also the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"


def _fixed_caches() -> None:
    """Every compiler cache in a fixed directory inside the checkout (the
    program builds its own kernels under ``build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 3
    try:
        import sskd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not beside the benchmark: {e}", file=sys.stderr)
        return 4
    from benchmark.harness.core import forbidden_modules, run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {', '.join(found)}", file=sys.stderr)
        return 5
    if result.trace_events_outside:
        print(f"trace: {result.trace_events_outside} device events outside the traced window "
              "(the profiler handed over another window's kernels)", file=sys.stderr)
    for name, value in result.readings.items():
        print(f"reading {name} {value!r} (held to no limit)", file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result.correct}", file=sys.stderr)
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
