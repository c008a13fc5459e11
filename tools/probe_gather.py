"""Timing probes behind bin_gather's tensor-core kernels
(``csrc/bin_gather.cu`` ``bin_gather_tc_kernel`` over int8 and packed int4
rows, ``bin_gather_bf16_tc_kernel`` over bf16 rows) on one NVIDIA GPU, over
1,000,000 x 384 seeded unit rows.

1. The tree's kernels, in turns, on the bins the exact engine's binmax
   chooses: int4 and bf16 on the tensor cores beside ``bin_gather_kernel``
   (``sskd_bin_gather`` mode 2 and 3, the kernel those rows took before),
   and int8 on the tensor cores, at B in {1, 16, 64, 256} and kb in {10,
   40, 100} (bf16 and int4 at 40, the refined engine's refine_m; bf16 not
   at 100, int8 not at 40); int4 checked bit for bit and bf16 within 1e-5
   against the plain version.
2. With ``--parent DIR``, a copy of an earlier commit's
   ``sskd_tpu_torch/csrc`` (``git archive <commit> sskd_tpu_torch/csrc |
   tar -x -C DIR``): the parent's int8 ``bin_gather_tc_kernel`` and
   ``cell_gather_tc_kernel`` (976 cells x 1,024 rows, nprobe 64, B in {16,
   64}) beside the tree's, in the same turns, and whether their results are
   equal bit for bit.

Each time is the device time a launch takes: CUDA events around 50 launches
queued behind a sleep kernel that holds the stream, so the host's pace does
not enter (the gathers take microseconds). Prints the card's name and power
limit and one JSON line per probe, and writes them to
``chiprun_out/probe_gather.json``.

    python3 tools/probe_gather.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import _build  # noqa: E402
from sskd_tpu_torch.ops import topk_kernels as tk  # noqa: E402
from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4  # noqa: E402

WORK = ROOT / "build" / "probe_gather"
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
N_ROWS, DIM = 1_000_000, 384
N_CELLS, CELL_ROWS, NPROBE = 976, 1024, 64
HOLD_CYCLES = 20_000_000  # ~10 ms of sleep: longer than queuing the launches takes


def held_ms(fn, iters: int = 50) -> float | None:
    """Device ms per call of ``fn``, its launches queued behind a sleep; None
    when the sleep ended before the last launch was queued."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    held = not a.query()
    torch.cuda.synchronize()
    return round(a.elapsed_time(b) / iters, 5) if held else None


def in_turns(calls: dict, rounds: int = 2) -> dict:
    """Device ms of each call, timed in turns forward then backward, ``rounds`` times."""
    out = {name: [] for name in calls}
    order = list(calls)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name].append(held_ms(calls[name]))
    return out


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def entry(lib, name: str, types: list):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = I, types
    return fn


def gather_call(lib, mode, q_in, q_scale, corpus, scales, bins, out, tc=True, with_mode=True):
    """A launch of a bin_gather entry: the tensor-core one (with its row type,
    or without it as int8 took it before), or bin_gather_kernel's."""
    B, kb = bins.shape
    n, row_bytes = corpus.shape[0], corpus.shape[1] * corpus.element_size()
    if not tc:
        fn = entry(lib, "sskd_bin_gather", [I, P, P, P, P, P, P, I, I, L, I, L, P])
        return lambda: fn(mode, ptr(q_in), ptr(q_scale), ptr(corpus), ptr(scales), ptr(bins),
                          ptr(out), B, kb, n, row_bytes // 4, n, stream())
    head = [I] if with_mode else []
    fn = entry(lib, "sskd_bin_gather_tc", head + [P, P, P, P, P, P, P, I, I, L, I, L, I, P])
    args = [ptr(q_in), ptr(q_scale), ptr(corpus), ptr(scales), ptr(bins), None, ptr(out), B, kb,
            n, row_bytes, n, 1]
    return lambda: fn(*([mode] if with_mode else []), *args, stream())


def cell_call(lib, q_in, q_scale, corpus, scales, cells, order, out):
    B = q_in.shape[0]
    fn = entry(lib, "sskd_cell_gather_tc", [P, P, P, P, P, P, P, I, I, I, I, P])
    return lambda: fn(ptr(q_in), ptr(q_scale), ptr(corpus), ptr(scales), ptr(cells), ptr(order),
                      ptr(out), B, NPROBE, CELL_ROWS, corpus.shape[1], stream())


def launched(calls: dict) -> None:
    for name, call in calls.items():
        rc = call()
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        torch.cuda.synchronize()


def build_parent(src_dir: Path) -> dict:
    WORK.mkdir(parents=True, exist_ok=True)
    libs = {}
    for stem in ("bin_gather", "cell_gather"):
        out = WORK / f"parent_{stem}.so"
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
                              str(out), str(src_dir / f"{stem}.cu")], capture_output=True,
                             text=True)
        if log.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {stem}:\n{log.stdout}{log.stderr}")
        libs[stem] = ctypes.CDLL(str(out))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's sskd_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record = {"nvidia_smi": smi, "rows": N_ROWS, "dim": DIM}
    built = _build.build_all()
    tree = {stem: ctypes.CDLL(str(built[stem].path)) for stem in ("bin_gather", "cell_gather")}
    parent = build_parent(Path(args.parent)) if args.parent else None

    def emit(key, value):
        record[key] = value
        print(json.dumps({key: value}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N_ROWS, DIM, device="cuda", generator=g)
    x /= x.norm(dim=1, keepdim=True)
    c8, s8 = quantize_rows(x)
    c4, s4 = quantize_rows_int4(x)
    cb = x.to(torch.bfloat16)
    del x
    for B in (1, 16, 64, 256):
        q = torch.randn(B, DIM, device="cuda", generator=g)
        q = q / q.norm(dim=1, keepdim=True)
        q8, qs = tk.quantize_queries(q, c8)
        maxima = tk.binmax(q8, c8, s8)
        for kb in (10, 40, 100):
            bins = tk.topk_stable(maxima.T, kb)[1].to(torch.int32).contiguous()
            outs = {}

            def out(name):
                outs[name] = torch.empty(B, kb, 128, device="cuda")
                return outs[name]
            calls = {
                "int4_tc": gather_call(tree["bin_gather"], 2, q8, qs, c4, s4, bins,
                                       out("int4_tc")),
                "int4_cuda_core": gather_call(tree["bin_gather"], 2, q8, qs, c4, s4, bins,
                                              out("int4_cuda_core"), tc=False),
            }
            if kb != 40:
                calls["int8_tc"] = gather_call(tree["bin_gather"], 1, q8, qs, c8, s8, bins,
                                               out("int8_tc"))
                if parent:
                    calls["parent_int8_tc"] = gather_call(parent["bin_gather"], 1, q8, qs, c8,
                                                          s8, bins, out("parent_int8_tc"),
                                                          with_mode=False)
            if kb != 100:
                calls["bf16_tc"] = gather_call(tree["bin_gather"], 3, q, None, cb, None, bins,
                                               out("bf16_tc"))
                calls["bf16_cuda_core"] = gather_call(tree["bin_gather"], 3, q, None, cb, None,
                                                      bins, out("bf16_cuda_core"), tc=False)
            launched(calls)
            res = in_turns(calls)
            res["distinct_bins"] = torch.unique(bins).numel()
            if "int4_tc" in outs:
                want = tk.bin_gather_plain(q8, qs, c4, s4, bins)
                res["int4_equal_to_plain"] = {k: bool(torch.equal(outs[k], want))
                                              for k in ("int4_tc", "int4_cuda_core")}
            if "bf16_tc" in outs:
                want = tk.bin_gather_plain(q, None, cb, None, bins)
                res["bf16_max_abs_err"] = {k: (outs[k] - want).abs().max().item()
                                           for k in ("bf16_tc", "bf16_cuda_core")}
            if "parent_int8_tc" in outs:
                res["parent_int8_bitwise_equal"] = bool(torch.equal(outs["parent_int8_tc"],
                                                                    outs["int8_tc"]))
            emit(f"bin_gather_B{B}_kb{kb}_ms", res)
    if parent:
        cells = c8[: N_CELLS * CELL_ROWS]
        cell_scales = s8[: N_CELLS * CELL_ROWS]
        for B in (16, 64):
            q = torch.randn(B, DIM, device="cuda", generator=g)
            q8, qs = tk.quantize_queries(q / q.norm(dim=1, keepdim=True), c8)
            probe = torch.stack([torch.randperm(N_CELLS, device="cuda", generator=g)[:NPROBE]
                                 for _ in range(B)]).to(torch.int32)
            sorted_cells, order = torch.sort(probe.view(-1), stable=True)
            outs = {k: torch.empty(B, NPROBE, CELL_ROWS, device="cuda")
                    for k in ("tree", "parent")}
            calls = {k: cell_call(lib, q8, qs, cells, cell_scales, sorted_cells, order, outs[k])
                     for k, lib in (("tree", tree["cell_gather"]),
                                    ("parent", parent["cell_gather"]))}
            launched(calls)
            res = in_turns(calls)
            res["bitwise_equal"] = bool(torch.equal(outs["tree"], outs["parent"]))
            emit(f"cell_gather_int8_B{B}_ms", res)
    out_path = ROOT / "chiprun_out" / "probe_gather.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
