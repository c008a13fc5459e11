"""Timing probe behind the bf16 flash forward at head dim 16
(``csrc/flash_attn.cu`` ``flash_fwd_tc2_kernel<16, FT16_MT, FT16_MINB>``, the
tiny models' encode at L = 512) on one NVIDIA GPU.

At [256, 4, 512, 16] with a ragged key mask (a row with no live key among
them), with every key live, at L = 200 and at B = 1, each in turns and on the
same inputs:

- the route's kernel through the wrapper (``flash_attention``);
- the other schedules of the tensor-core kernel, ``flash_fwd_tc2_kernel<16,
  MT, MINB>`` for m-tiles a warp MT in {1, 2, 4} and blocks an SM MINB up to
  8 (``tools/flash_d16_variants.cuh`` ``FLASH16_VARIANTS``), held bit for bit
  against the wrapper's launch;
- ``flash_fwd_kernel``, the CUDA-core kernel the route took before, from the
  same header;
- F.scaled_dot_product_attention with the same mask, and the plain version.

Each is held against the plain version (``flash_error_bound``). Each time is
CUDA events over 20 launches (``ms``) and the same launches behind a held
stream (``device_ms``). Beside them the floors: the bytes at 3.35 TB/s, the
products at bf16's 989 TFLOP/s and one ex2 a score on the special-function
unit, and ptxas's registers and spills of every kernel built. Prints the
card's name and power limit and one JSON line a shape, and writes them to
``chiprun_out/probe_flash16.json``.

    python3 tools/probe_flash16.py
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import _build  # noqa: E402
from sskd_tpu_torch.ops import attention as ta  # noqa: E402

WORK = ROOT / "build" / "probe_flash16"
P = ctypes.c_void_p
HBM, BF16 = 3.35e12, 989e12
SFU_EXPS_PER_S = 16 * 132 * 1.98e9  # 16 a clock an SM, 132 SMs, ~1.98 GHz
HOLD_CYCLES = 400_000_000
SOURCE = '#include "flash_attn.cu"\n#include "flash_d16_variants.cuh"\n'

# the probe entry's variant numbers (tools/flash_d16_variants.cuh): 0 the
# CUDA-core kernel, 1 the route's schedule, then flash_fwd_tc2_kernel<16, MT,
# MINB> by "mt{MT}_b{MINB}"
VARIANTS = {"cuda_core": 0, "route_schedule": 1, "mt1_b1": 2, "mt1_b4": 3, "mt1_b8": 4,
            "mt2_b2": 5, "mt2_b3": 6, "mt2_b5": 7, "mt4_b1": 8}


def start_build(work: Path = WORK) -> tuple[subprocess.Popen, Path]:
    """Starts nvcc on the probe library (flash_attn.cu and the header); returns
    the process and the library's path, for ``load``."""
    work.mkdir(parents=True, exist_ok=True)
    src, out = work / "probe_flash16.cu", work / "probe_flash16.so"
    src.write_text(SOURCE)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-I",
                             str(ROOT / "tools"), "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def ptxas_summary(log: str) -> dict:
    """{kernel: {registers, smem_bytes, spill_bytes}} from nvcc's -Xptxas -v."""
    summary, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            summary.setdefault(kernel, {}).update(
                registers=int(m.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            summary.setdefault(kernel, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return summary


def load(build: tuple[subprocess.Popen, Path]):
    """(the probe's C entry, ptxas's summary) once ``start_build``'s nvcc ends."""
    proc, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the flash d = 16 probe:\n{log}")
    fn = ctypes.CDLL(str(out)).probe_flash16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [P]
    return fn, ptxas_summary(log)


def launcher(fn, variant: int, q, k, v, mask, out):
    """A call that launches ``variant`` on these tensors and raises on an
    error code."""
    B, h, L, d = q.shape
    args = [P(t.data_ptr()) for t in (q, k, v, mask, out)]
    sm_scale, scale_log2 = 1.0 / d**0.5, ta._scale_log2(d)

    def call():
        rc = fn(variant, *args, B, h, L, sm_scale, scale_log2,
                P(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"probe_flash16 variant {variant}: cudaError {rc}")
    return call


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


def device_ms(fn, iters: int = 20) -> float | None:
    """CUDA events over ``iters`` launches queued behind a sleep kernel, so
    they run back to back whatever the host's pace; None if the sleep ended
    before the last launch was queued."""
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


def in_turns(calls: dict, rounds: int = 2) -> dict:
    """ms (events) and device ms of each call, in turns forward then back."""
    out = {name: {"ms": [], "device_ms": []} for name in calls}
    order = list(calls)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name]["ms"].append(event_ms(calls[name]))
            out[name]["device_ms"].append(device_ms(calls[name]))
    return out


def inputs(B: int, L: int, mask_kind: str, g: torch.Generator):
    """bf16 q, k, v [B, 4, L, 16] and a key mask: "ragged" (lengths from L / 8
    to L, the first row whole and, from B = 3, the second with no live key)
    or "full"."""
    q, k, v = (torch.randn(B, 4, L, 16, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    if mask_kind == "full":
        return q, k, v, torch.ones(B, L, dtype=torch.int32, device="cuda")
    lens = torch.randint(max(1, L // 8), L + 1, (B,), device="cuda", generator=g)
    lens[0] = L
    if B >= 3:
        lens[1] = 0
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def floors(B: int, h: int, L: int, d: int) -> dict:
    return {"bytes_bound_ms": (4 * B * h * L * d * 2 + B * L * 4) / HBM * 1e3,
            "products_ms": 4.0 * B * h * L * L * d / BF16 * 1e3,
            "exp_floor_ms": B * h * L * L / SFU_EXPS_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_flash16: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build = start_build()
    _build.build_all()
    fn, ptxas = load(build)
    record = {"nvidia_smi": smi, "ptxas": ptxas}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, L, mask_kind in ((256, 512, "ragged"), (256, 512, "full"), (64, 200, "ragged"),
                            (1, 512, "ragged")):
        q, k, v, mask = inputs(B, L, mask_kind, g)
        outs = {name: torch.empty_like(q) for name in VARIANTS}
        calls = {name: launcher(fn, n, q, k, v, mask, outs[name]) for name, n in VARIANTS.items()}
        for call in calls.values():
            call()
        route_out = ta.flash_attention(q, k, v, mask)
        want = ta.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        res = {"shape": [B, 4, L, 16], "mask": mask_kind, "route": ta.flash_route(q.dtype, 16)}
        for name in (*VARIANTS, "route"):
            got = route_out if name == "route" else outs[name]
            diff = (got.float() - want.float()).abs()
            res[f"{name}_err_over_bound"] = (
                diff / ta.flash_error_bound(q, k, v, mask, got, want)).max().item()
            res[f"{name}_max_abs_err"] = diff.max().item()
            if name not in ("route", "cuda_core"):
                res[f"{name}_bitwise_equal_route"] = bool(torch.equal(got, route_out))
        keep = mask[:, None, None, :].bool()
        calls["route"] = lambda: ta.flash_attention(q, k, v, mask)
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        res["times"] = in_turns(calls)
        res["plain_ms"] = event_ms(lambda: ta.flash_attention_plain(q, k, v, mask), 3)
        res.update(floors(B, 4, L, 16))
        record[f"{B}x4x{L}x16_{mask_kind}"] = res
        print(json.dumps({f"{B}x4x{L}x16_{mask_kind}": res}), flush=True)
        del q, k, v, mask, outs, calls, route_out, want
    out = ROOT / "chiprun_out" / "probe_flash16.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
