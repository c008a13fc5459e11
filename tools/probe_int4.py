"""Timing probes behind the packed-int4 route of the tensor-core top-k
kernels (``csrc/binmax.cu`` ``binmax_tc_kernel`` / ``binmax_strided_tc_kernel``
with ``PACKED``) on one NVIDIA GPU, over 1,000,000 x 384 seeded unit rows.

1. The tree's kernels, in turns: int4 on the tensor cores, int4 on the dp4a
   kernels (``sskd_binmax`` / ``sskd_binmax_strided`` mode 2, the route the
   wrapper took before) and int8 on the tensor cores, at B in {1, 16, 64,
   256}; each int4 result checked bit for bit against the plain version.
2. With ``--parent DIR``, a copy of an earlier commit's
   ``sskd_tpu_torch/csrc`` (``git archive <commit> sskd_tpu_torch/csrc |
   tar -x -C DIR``): the parent's int8 tensor-core kernels beside the
   tree's, in the same turns, and whether their results are equal bit for
   bit.

Prints the card's name and power limit and one JSON line per probe, and
writes them to ``chiprun_out/probe_int4.json``.

    python3 tools/probe_int4.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import _build  # noqa: E402
from sskd_tpu_torch.ops import topk_kernels as tk  # noqa: E402
from sskd_tpu_torch.ops.quant import quantize_rows, quantize_rows_int4  # noqa: E402
from sskd_tpu_torch.ops.topk import approx_blocks, approx_min_bins  # noqa: E402

WORK = ROOT / "build" / "probe_int4"
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
N_ROWS, DIM = 1_000_000, 384


def t_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def in_turns(calls: dict, rounds: int = 2) -> dict:
    """ms of each call, timed in turns forward then backward, ``rounds`` times."""
    out = {name: [] for name in calls}
    order = list(calls)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name].append(round(t_ms(calls[name]), 4))
    return out


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


def stream() -> P:
    return P(torch.cuda.current_stream().cuda_stream)


def entry(lib, name: str, types: list):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = I, types
    return fn


def binmax_call(lib, mode, q_in, corpus, scales, out, tc=True, with_mode=True):
    """A launch of the binmax entry: the tensor-core one (with its row type,
    or without it as before packed rows took it) or the dp4a one."""
    B, n, row_bytes = q_in.shape[0], corpus.shape[0], corpus.shape[1]
    if not tc:
        fn = entry(lib, "sskd_binmax", [I, P, P, P, P, I, L, I, L, P])
        return lambda: fn(mode, ptr(q_in), ptr(corpus), ptr(scales), ptr(out), B, n,
                          row_bytes // 4, n, stream())
    head = [I] if with_mode else []
    fn = entry(lib, "sskd_binmax_tc", head + [P, P, P, P, I, L, I, L, P])
    args = [ptr(q_in), ptr(corpus), ptr(scales), ptr(out), B, n, row_bytes, n]
    return lambda: fn(*([mode] if with_mode else []), *args, stream())


def strided_call(lib, mode, q_in, corpus, scales, out, rows, blocks, tc=True, with_mode=True):
    B, n, row_bytes = q_in.shape[0], corpus.shape[0], corpus.shape[1]
    if not tc:
        fn = entry(lib, "sskd_binmax_strided", [I, P, P, P, P, P, I, L, I, L, I, P])
        return lambda: fn(mode, ptr(q_in), ptr(corpus), ptr(scales), ptr(out), ptr(rows), B, n,
                          row_bytes // 4, n, blocks, stream())
    head = [I] if with_mode else []
    fn = entry(lib, "sskd_binmax_strided_tc", head + [P, P, P, P, P, I, L, I, L, I, P])
    args = [ptr(q_in), ptr(corpus), ptr(scales), ptr(out), ptr(rows), B, n, row_bytes, n, blocks]
    return lambda: fn(*([mode] if with_mode else []), *args, stream())


def launched(calls: dict) -> None:
    for name, call in calls.items():
        rc = call()
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's sskd_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_int4: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record = {"nvidia_smi": smi, "rows": N_ROWS, "dim": DIM}
    tree_lib = ctypes.CDLL(str(_build.build_all()["binmax"].path))
    parent_lib = None
    if args.parent:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        src = Path(args.parent) / "binmax.cu"
        out = WORK / "parent.so"
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                              str(out), str(src)], capture_output=True, text=True)
        if log.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent:\n{log.stdout}{log.stderr}")
        parent_lib = ctypes.CDLL(str(out))

    def emit(key, value):
        record[key] = value
        print(json.dumps({key: value}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N_ROWS, DIM, device="cuda", generator=g)
    x /= x.norm(dim=1, keepdim=True)
    c4, s4 = quantize_rows_int4(x)
    c8, s8 = quantize_rows(x)
    del x
    n_bins = (N_ROWS + 127) // 128
    groups = math.ceil(approx_min_bins(10, 0.99) / 128)
    for B in (1, 16, 64, 256):
        q = torch.randn(B, DIM, device="cuda", generator=g)
        q_in, _ = quantize_rows(q / q.norm(dim=1, keepdim=True))
        blocks = approx_blocks(B, groups, n_bins)
        names = ["tc", "dp4a", "int8_tc"]
        outs = {k: torch.empty(n_bins, B, device="cuda") for k in names}
        calls = {"tc": binmax_call(tree_lib, 2, q_in, c4, s4, outs["tc"]),
                 "dp4a": binmax_call(tree_lib, 2, q_in, c4, s4, outs["dp4a"], tc=False),
                 "int8_tc": binmax_call(tree_lib, 1, q_in, c8, s8, outs["int8_tc"])}
        if args.parent:
            outs["parent_int8_tc"] = torch.empty(n_bins, B, device="cuda")
            calls["parent_int8_tc"] = binmax_call(parent_lib, 1, q_in, c8, s8,
                                                  outs["parent_int8_tc"], with_mode=False)
        launched(calls)
        res = in_turns(calls)
        want = tk.binmax_plain(q_in, c4, s4)
        res["equal_to_plain"] = {k: bool(torch.equal(outs[k], want))
                                 for k in ("tc", "dp4a")}
        if args.parent:
            res["parent_int8_bitwise_equal"] = bool(torch.equal(outs["parent_int8_tc"],
                                                                outs["int8_tc"]))
        emit(f"binmax_B{B}_ms", res)

        span = blocks * 128
        outs = {k: (torch.empty(span, B, device="cuda"),
                    torch.empty(span, B, dtype=torch.int32, device="cuda")) for k in names}
        calls = {"tc": strided_call(tree_lib, 2, q_in, c4, s4, *outs["tc"], blocks),
                 "dp4a": strided_call(tree_lib, 2, q_in, c4, s4, *outs["dp4a"], blocks,
                                      tc=False),
                 "int8_tc": strided_call(tree_lib, 1, q_in, c8, s8, *outs["int8_tc"], blocks)}
        if args.parent:
            outs["parent_int8_tc"] = (torch.empty(span, B, device="cuda"),
                                      torch.empty(span, B, dtype=torch.int32, device="cuda"))
            calls["parent_int8_tc"] = strided_call(parent_lib, 1, q_in, c8, s8,
                                                   *outs["parent_int8_tc"], blocks,
                                                   with_mode=False)
        launched(calls)
        res = in_turns(calls)
        want = tk.binmax_strided_plain(q_in, c4, s4, None, blocks)
        res["blocks"] = blocks
        res["equal_to_plain"] = {k: all(bool(torch.equal(a, b)) for a, b in zip(outs[k], want))
                                 for k in ("tc", "dp4a")}
        if args.parent:
            res["parent_int8_bitwise_equal"] = all(
                bool(torch.equal(a, b)) for a, b in zip(outs["parent_int8_tc"], outs["int8_tc"]))
        emit(f"binmax_strided_B{B}_ms", res)
    out = ROOT / "chiprun_out" / "probe_int4.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
