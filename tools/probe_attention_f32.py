"""Timing probe behind the f32 attention forwards at head dims 16 and 32
(``csrc/flash_attn.cu`` ``flash_fwd_tc_tf32_kernel<D>``,
``csrc/dropattn_fwd.cu`` ``dropattn_fwd_tc_tf32_kernel<D>``) on one NVIDIA
GPU.

At the shapes the port runs them (flash: the f32 encode [256, 12, 512, 32];
dropattn_fwd: the f32 student's [256, 12, 192, 32] at p 0.1 and 0, and the
tiny teacher's [32, 4, 64, 16] at p 0.1), each in turns and on the same
inputs:

- the route's kernel, through the probe's own entry and through the wrapper;
- the other schedules of ``tools/attention_f32_variants.cuh`` (4 or 8 warps a
  block, q split once, S an 8-key tile at a time, and K and V split into
  their TF32 terms once a tile for the block, two ways), which compute the
  same bits;
- with ``--parent DIR`` (an earlier commit's ``sskd_tpu_torch/csrc``:
  ``git archive <commit> sskd_tpu_torch/csrc | tar -x -C DIR``), that
  commit's f32 kernels through its C entries (before the tensor-core
  route at these head dims, the CUDA-core ``flash_fwd_kernel<float, D>`` /
  ``dropattn_fwd_kernel<float, D>``);
- F.scaled_dot_product_attention with the same mask (and dropout), and the
  plain version.

Each is held against the plain version (max abs err) and, bit for bit,
against the wrapper's launch; each time is CUDA events over 20 launches
(``ms``) and the same launches behind a held stream (``device_ms``: the
card's time where the host's pace is slower). Beside them the bounds: the
bytes at 3.35 TB/s, the three TF32 passes at 495 TFLOP/s, the CUDA cores'
FMA at 67 TFLOP/s, one expf a score on the special-function unit, and, for
dropout, what p 0.1 adds to p 0 on the route's kernel (the Philox floor),
with ptxas's registers and spills of every kernel built. Prints the card's
name and power limit and one JSON line per shape, and writes them to
``chiprun_out/probe_attention_f32.json``.

    python3 tools/probe_attention_f32.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import _build  # noqa: E402
from sskd_tpu_torch.ops import attention as ta  # noqa: E402

WORK = ROOT / "build" / "probe_attention_f32"
P = ctypes.c_void_p
HBM, TF32, FMA = 3.35e12, 495e12, 67e12
SFU_EXPS_PER_S = 16 * 132 * 1.98e9  # 16 a clock an SM, 132 SMs, ~1.98 GHz
HOLD_CYCLES = 400_000_000

# the schedules timed, by the variant number each probe entry takes: 0 the
# route's kernel; the others from tools/attention_f32_variants.cuh
VARIANTS = {"route_kernel": 0, "tuned_4w": 1, "tuned_8w": 2, "tuned_split_8w": 3,
            "tuned_split_4w": 4, "prefetch_split_8w": 5}
DISPATCH = r"""
  switch (variant) {
    case 0: return launch_tf32<D>(ARGS);
    case 1: return launch_tf32_tuned<D, 4, false>(ARGS);
    case 2: return launch_tf32_tuned<D, 8, false>(ARGS);
    case 3: return launch_tf32_tuned<D, 8, true>(ARGS);
    case 4: return launch_tf32_tuned<D, 4, true>(ARGS);
    case 5: return launch_tf32_split<D, 8>(ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
"""
PROBE_SRC = {
    "flash_attn": r"""#include "flash_attn.cu"
#define SSKD_PROBE_FLASH
#include "attention_f32_variants.cuh"
#define ARGS q, k, v, mask, out, B, h, L, sm_scale, s
namespace sskd {
template <int D>
static int run(int variant, const float* q, const float* k, const float* v, const int* mask,
               float* out, int B, int h, int L, float sm_scale,
               cudaStream_t s) {""" + DISPATCH + r"""}
extern "C" int probe_f32(int variant, const float* q, const float* k, const float* v,
                         const int* mask, float* out, int B, int h, int L, int d,
                         float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = d == 32 ? sskd::run<32>(variant, ARGS) : d == 16 ? sskd::run<16>(variant, ARGS)
                                                                  : (int)cudaErrorInvalidValue;
  return rc != 0 ? rc : (int)cudaGetLastError();
}
""",
    "dropattn_fwd": r"""#include "dropattn_fwd.cu"
#define SSKD_PROBE_DROPATTN
#include "attention_f32_variants.cuh"
#define ARGS q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s
namespace sskd {
template <int D>
static int run(int variant, const float* q, const float* k, const float* v, const float* bias,
               float* out, float* lse, int B, int h, int L, float sm_scale, uint32_t seed,
               float p, float inv, cudaStream_t s) {""" + DISPATCH + r"""}
extern "C" int probe_f32(int variant, const float* q, const float* k, const float* v,
                         const float* bias, float* out, float* lse, int B, int h, int L, int d,
                         float sm_scale, uint32_t seed, float p, float inv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = d == 32 ? sskd::run<32>(variant, ARGS) : d == 16 ? sskd::run<16>(variant, ARGS)
                                                                  : (int)cudaErrorInvalidValue;
  return rc != 0 ? rc : (int)cudaGetLastError();
}
""",
}


def nvcc(src: Path, out: Path, include: Path) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-I",
                             str(ROOT / "tools"), "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def built(procs: dict) -> tuple[dict, dict]:
    """The loaded libraries and ptxas's registers and spills of each."""
    libs, ptxas = {}, {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line or "entry function" in line]
    return libs, ptxas


def stream() -> P:
    return P(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


def checked(call):
    def run():
        rc = call()
        if rc != 0:
            raise RuntimeError(f"launch failed with cudaError {rc}")
    return run


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


def flash_calls(libs, parent, q, k, v, mask, outs):
    B, h, L, d = q.shape
    args = (ptr(q), ptr(k), ptr(v), ptr(mask))
    scale = 1.0 / d**0.5
    probe = libs["probe_flash_attn"].probe_f32
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int] + [P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, P]
    calls = {}
    for name, variant in VARIANTS.items():
        calls[name] = checked(lambda variant=variant, o=outs[name]: probe(
            variant, *args, ptr(o), B, h, L, d, scale, stream()))
    calls["route"] = lambda: ta.flash_attention(q, k, v, mask)
    if parent is not None:
        fn = parent.sskd_flash_attn_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, P]
        calls["parent"] = checked(lambda: fn(0, *args, ptr(outs["parent"]), B, h, L, d, scale,
                                             stream()))
    return calls


def dropattn_calls(libs, parent, q, k, v, bias, p, seed, outs):
    B, h, L, d = q.shape
    args = (ptr(q), ptr(k), ptr(v), ptr(bias))
    tail = (B, h, L, d, 1.0 / d**0.5, seed, p, 1.0 / (1.0 - p))
    probe = libs["probe_dropattn_fwd"].probe_f32
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int] + [P] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
    calls = {}
    for name, variant in VARIANTS.items():
        calls[name] = checked(lambda variant=variant, o=outs[name]: probe(
            variant, *args, ptr(o[0]), ptr(o[1]), *tail, stream()))
    calls["route"] = lambda: ta.dropattn_fwd(q, k, v, bias, p, seed)
    if parent is not None:
        fn = parent.sskd_dropattn_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [P] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
        o = outs["parent"]
        calls["parent"] = checked(lambda: fn(0, *args, ptr(o[0]), ptr(o[1]), *tail, stream()))
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's sskd_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_attention_f32: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    procs = {}
    for stem, body in PROBE_SRC.items():
        src = WORK / f"probe_{stem}.cu"
        src.write_text(body)
        procs[f"probe_{stem}"] = (nvcc(src, WORK / f"probe_{stem}.so", _build.CSRC),
                                  WORK / f"probe_{stem}.so")
        if args.parent:
            psrc = Path(args.parent) / f"{stem}.cu"
            procs[f"parent_{stem}"] = (nvcc(psrc, WORK / f"parent_{stem}.so", psrc.parent),
                                       WORK / f"parent_{stem}.so")
    _build.build_all()
    libs, ptxas = built(procs)
    record = {"nvidia_smi": smi, "ptxas": {n: ptxas[n] for n in ptxas if n.startswith("probe")}}

    def emit(key, value):
        record[key] = value
        print(json.dumps({key: value}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)

    # flash at the f32 encode's shape, a ragged key mask as the encoder's
    B, h, L, d = 256, 12, 512, 32
    q, k, v = (torch.randn(B, h, L, d, device="cuda", generator=g) for _ in range(3))
    lens = torch.randint(L // 8, L + 1, (B,), device="cuda", generator=g)
    lens[0] = L
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    names = (*VARIANTS, "parent")
    outs = {n: torch.empty_like(q) for n in names}
    calls = flash_calls(libs, libs.get("parent_flash_attn"), q, k, v, mask, outs)
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    route_out = ta.flash_attention(q, k, v, mask)
    want = ta.flash_attention_plain(q, k, v, mask)
    res = {"shape": [B, h, L, d], "route": ta.flash_route(q.dtype, d)}
    for n in names:
        if n in calls:
            res[f"{n}_max_abs_err"] = (outs[n] - want).abs().max().item()
            res[f"{n}_bitwise_equal_route"] = bool(torch.equal(outs[n], route_out))
    res["route_max_abs_err"] = (route_out - want).abs().max().item()
    keep = mask[:, None, None, :].bool()
    calls["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    res["times"] = in_turns(calls)
    res["plain_ms"] = event_ms(lambda: ta.flash_attention_plain(q, k, v, mask), 3)
    ops = 4.0 * B * h * L * L * d
    res["bytes_bound_ms"] = (4 * B * h * L * d * 4 + B * L * 4) / HBM * 1e3
    res["three_pass_ms"] = 3 * ops / TF32 * 1e3
    res["fma_bound_ms"] = ops / FMA * 1e3
    res["exp_floor_ms"] = B * h * L * L / SFU_EXPS_PER_S * 1e3
    emit("flash_f32_d32", res)
    del q, k, v, outs, route_out, want, calls

    for (B, h, L, d), ps in (((256, 12, 192, 32), (0.1, 0.0)), ((32, 4, 64, 16), (0.1,))):
        q, k, v = (torch.randn(B, h, L, d, device="cuda", generator=g) for _ in range(3))
        lens = torch.randint(max(1, L // 8), L + 1, (B,), device="cuda", generator=g)
        lens[0] = L
        bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0,
                           torch.finfo(torch.bfloat16).min / 2).float()
        for p in ps:
            seed = 7 + L
            outs = {n: (torch.empty_like(q), torch.empty(B, h, L, device="cuda"))
                    for n in names}
            calls = dropattn_calls(libs, libs.get("parent_dropattn_fwd"), q, k, v, bias, p,
                                   seed, outs)
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            route_out, route_lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
            want, want_lse = ta.dropattn_fwd_plain(q, k, v, bias, p, seed)
            res = {"shape": [B, h, L, d], "p": p, "route": ta.dropattn_fwd_route(q.dtype, d, L)}
            for n in names:
                if n in calls:
                    res[f"{n}_max_abs_err"] = (outs[n][0] - want).abs().max().item()
                    res[f"{n}_lse_max_abs_err"] = (outs[n][1] - want_lse).abs().max().item()
                    res[f"{n}_bitwise_equal_route"] = bool(
                        torch.equal(outs[n][0], route_out) and torch.equal(outs[n][1], route_lse))
            res["route_max_abs_err"] = (route_out - want).abs().max().item()
            amask = bias[:, None, None, :]
            calls["sdpa_dropout"] = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=amask, dropout_p=p)
            res["times"] = in_turns(calls)
            res["plain_ms"] = event_ms(lambda: ta.dropattn_fwd_plain(q, k, v, bias, p, seed), 2)
            ops = 4.0 * B * h * L * L * d
            res["bytes_bound_ms"] = (4 * B * h * L * d * 4 + B * L * 4) / HBM * 1e3
            res["three_pass_ms"] = 3 * ops / TF32 * 1e3
            res["fma_bound_ms"] = ops / FMA * 1e3
            res["exp_floor_ms"] = B * h * L * L / SFU_EXPS_PER_S * 1e3
            res["philox_calls"] = B * h * L * L // 4
            emit(f"dropattn_fwd_f32_{B}x{h}x{L}x{d}_p{p}", res)
            del outs, calls, route_out, route_lse, want, want_lse
        if len(ps) == 2:  # the Philox floor on the route's kernel: p 0.1 less p 0
            a = record[f"dropattn_fwd_f32_{B}x{h}x{L}x{d}_p0.1"]["times"]["route"]["device_ms"]
            b = record[f"dropattn_fwd_f32_{B}x{h}x{L}x{d}_p0.0"]["times"]["route"]["device_ms"]
            if None not in a + b:
                record[f"dropattn_fwd_f32_{B}x{h}x{L}x{d}_p0.1"]["philox_floor_ms"] = (
                    min(a) - min(b))
        del q, k, v
    out = ROOT / "chiprun_out" / "probe_attention_f32.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
