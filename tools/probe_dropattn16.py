"""Timing probe behind the bf16 resident dropattn backward (``csrc/
dropattn_bwd.cu``) at head dim 16, where the route chose between
``dropattn_bwd_tc_kernel<16>`` (a whole head a block with an [Lp, Lp]
buffer of pd then ds: one 12-warp block an SM at L = 192) and
``dropattn_bwd_tc_3pass_kernel<16>`` (no buffer: dv and dk from registers in
a third pass over the keys), on one NVIDIA GPU.

At [256, 4, 192, 16] (pipeline (b)'s doc tower) and [32, 4, 64, 16] (its
query tower), p 0 and 0.1, in turns and on the same inputs:

- ``buffer``: dropattn_bwd_tc_kernel<16> (the kernel the route took before);
- ``three_pass``: dropattn_bwd_tc_3pass_kernel<16>;
- ``stream``: the streaming route's three kernels at d = 16;
- ``route``: the wrapper, whichever it launches;
- SDPA's backward with the same bias and dropout (the yardstick).

Then the other head dims at the shapes their paths run, the buffer kernel
against the three-pass one: [256, 12, 192, 32] (the KD student) and [32,
16, 64, 64] (the teacher), p 0.1 and 0.

Each candidate is held against the plain pair (``dropattn_bwd_error_bound``,
the ratio of the largest error to its bound) and against the buffer kernel
bit for bit. Each time is the card's (CUDA events around 20 launches queued
behind a sleep kernel: ``device_ms``) and, for the wrapper, events at the
host's pace (``ms``). Host pace: at [32, 4, 64, 16] and [32, 16, 64, 64] the
wrapper's events against the card's time, and the resident C entry
(sskd_dropattn_bwd_tc) called by ctypes alone, of this tree and, with
``--parent DIR`` (an earlier commit's ``sskd_tpu_torch/csrc``: ``git archive
<commit> sskd_tpu_torch/csrc | tar -x -C DIR``), of that commit, whose
launch queried the occupancy on every call. Beside them the bounds: bytes
at 3.35 TB/s, the five products at the bf16 tensor-core peak, and the
Philox floor (p 0.1 less p 0 on the route's kernel). Prints the card's name
and power limit and one JSON line per shape and writes them to
``chiprun_out/probe_dropattn16.json``.

    python3 tools/probe_dropattn16.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import _build  # noqa: E402
from sskd_tpu_torch.ops import attention as ta  # noqa: E402

WORK = ROOT / "build" / "probe_dropattn16"
HBM, BF16 = 3.35e12, 989e12
HOLD_CYCLES = 200_000_000
ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p]


def held_ms(fn, iters: int = 20) -> float | None:
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
    return a.elapsed_time(b) / iters if held else None


def event_ms(fn, iters: int = 20) -> float:
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


def host_us(fn, calls: int = 500) -> float:
    """Host microseconds a call, the stream left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    el = time.perf_counter() - t0
    torch.cuda.synchronize()
    return el / calls * 1e6


def inputs(B, h, L, d, g):
    q, k, v, go = (torch.randn(B, h, L, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    lens = torch.randint(max(1, L // 8), L + 1, (B,), device="cuda", generator=g)
    lens[0] = L
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0,
                       torch.finfo(torch.bfloat16).min / 2).float().contiguous()
    return q, k, v, go, bias


def slack(q, k, v, bias, p, seed, lse, go, got, want) -> float:
    bounds = ta.dropattn_bwd_error_bound(q, k, v, bias, p, seed, lse, go, got, want)
    return max(((a.float() - b.float()).abs() / bd).max().item()
               for a, b, bd in zip(got, want, bounds))


def resident_entry(lib):
    fn = lib.sskd_dropattn_bwd_tc
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's sskd_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dropattn16: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    parent = None
    if args.parent:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        psrc = Path(args.parent) / "dropattn_bwd.cu"
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(psrc.parent),
                                 "-o", str(WORK / "parent_dropattn_bwd.so"), str(psrc)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = _build.build_all()
    if args.parent:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent:\n{log}")
        parent = resident_entry(ctypes.CDLL(str(WORK / "parent_dropattn_bwd.so")))
    tree = resident_entry(_build.load_library("dropattn_bwd"))
    # registers and spills of the tree's kernels ("" when the library was built before)
    record = {"nvidia_smi": smi, "ptxas": [
        line.strip() for line in built["dropattn_bwd"].ptxas_log.splitlines()
        if "entry function" in line or "registers" in line or "spill" in line]}

    def emit(key, value):
        record[key] = value
        print(json.dumps({key: value}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    for (B, h, L, d), ps in (((256, 4, 192, 16), (0.1, 0.0)), ((32, 4, 64, 16), (0.1, 0.0)),
                             ((256, 12, 192, 32), (0.1, 0.0)), ((32, 16, 64, 64), (0.1, 0.0))):
        q, k, v, go, bias = inputs(B, h, L, d, g)
        mask = bias.to(torch.bfloat16)[:, None, None, :]
        for p in ps:
            seed = 11 + L + d
            _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
            want = ta.dropattn_bwd_plain(q, k, v, bias, p, seed, lse, go)
            calls = {
                "buffer": lambda: ta.dropattn_bwd_tc_kernel(0, q, k, v, bias, p, seed, lse, go),
                "three_pass": lambda: ta.dropattn_bwd_tc_kernel(1, q, k, v, bias, p, seed, lse,
                                                                go),
                "route": lambda: ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go),
            }
            if d == 16:
                calls["stream"] = lambda: ta._dropattn_bwd_stream(q, k, v, bias, p, seed, lse,
                                                                  go)[:3]
            res = {"shape": [B, h, L, d], "p": p,
                   "route": ta.dropattn_bwd_route(q.dtype, d, L),
                   "route_is_three_pass": (q.dtype, d) in ta.DROPATTN_BWD_THREE_PASS}
            base = calls["buffer"]()
            for name, call in calls.items():
                got = call()
                again = call()
                torch.cuda.synchronize()
                res[f"{name}_err_over_bound"] = slack(q, k, v, bias, p, seed, lse, go, got, want)
                res[f"{name}_max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                                 for a, b in zip(got, want))
                res[f"{name}_bitwise_equal_buffer"] = all(torch.equal(a, b)
                                                          for a, b in zip(got, base))
                res[f"{name}_repeatable"] = all(torch.equal(a, b) for a, b in zip(got, again))
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=p)
            calls["sdpa_backward"] = lambda: torch.autograd.grad(lib_out, leaves, go,
                                                                 retain_graph=True)
            times = {name: [] for name in calls}
            for _ in range(2):
                for name in list(calls) + list(calls)[::-1]:
                    times[name].append(held_ms(calls[name]))
            res["device_ms"] = times
            res["route_ms"] = event_ms(calls["route"])
            elt = B * h * L * d * 2
            res["bytes_bound_ms"] = (7 * elt + B * L * 4) / HBM * 1e3
            res["operations_bound_ms"] = 10.0 * B * h * L * L * d / BF16 * 1e3
            emit(f"bwd_{B}x{h}x{L}x{d}_p{p}", res)
            del want, lib_out, leaves, calls, base
        a = record[f"bwd_{B}x{h}x{L}x{d}_p0.1"]["device_ms"]
        b = record[f"bwd_{B}x{h}x{L}x{d}_p0.0"]["device_ms"]
        for name in ("buffer", "three_pass"):
            if None not in a[name] + b[name]:
                record[f"bwd_{B}x{h}x{L}x{d}_p0.1"][f"{name}_philox_ms"] = (
                    min(a[name]) - min(b[name]))
        del q, k, v, go, bias

    # host pace of the resident launch: the C entry alone (this tree's caches
    # its launch choice; the parent's queried the occupancy each call) and the
    # wrapper, against the card's time
    for B, h, L, d in ((32, 4, 64, 16), (32, 16, 64, 64)):
        q, k, v, go, bias = inputs(B, h, L, d, g)
        p, seed = 0.1, 5
        _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
        outs = [torch.empty_like(q) for _ in range(3)]
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        ptrs = [t.data_ptr() for t in (q, k, v, bias, go, lse, *outs)]
        tail = (B, h, L, d, 1.0 / d**0.5, ta._scale_log2(d), seed, p, 1.0 / (1.0 - p), stream)
        entries = {"tree_entry": tree, "parent_entry": parent}
        res = {"shape": [B, h, L, d], "p": p}
        for name, fn in entries.items():
            if fn is None:
                continue
            call = (lambda fn=fn: fn(1, *ptrs, *tail))
            res[f"{name}_host_us"] = host_us(call)
            res[f"{name}_ms"] = event_ms(call)
            res[f"{name}_device_ms"] = held_ms(call)
        route = (lambda: ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go))
        res["wrapper_host_us"] = host_us(route)
        res["wrapper_ms"] = event_ms(route)
        res["wrapper_device_ms"] = held_ms(route)
        emit(f"host_pace_{B}x{h}x{L}x{d}", res)
        del q, k, v, go, bias, outs
    out = ROOT / "chiprun_out" / "probe_dropattn16.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
