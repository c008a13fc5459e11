"""Timing probe behind bin_gather's f32 route (``csrc/bin_gather.cu``
``bin_gather_f32_tc_kernel``: each product as three TF32 products on
mma.sync m16n8k8, the rows streamed through a ring of 32-float chunks) on one
NVIDIA GPU, over seeded unit rows of 384 floats.

At the shapes the port runs it, on the bins the exact engine's plain binmax
chooses: an f32 index's ``/search`` (1,000,000 rows, B in {1, 16, 64} at
kb = 10, and B = 256 at kb in {10, 30, 60, 100}: where sorting the pairs by
bin starts to pay) and the evaluator's (8,192 rows, B = 1,000 queries, kb =
20), in turns and on the same inputs:

- the wrapper (``tk.bin_gather``: its layout, and the sort where it sorts);
- each block layout of ``bin_gather_f32_tc_kernel<WARPS, QMAX, STAGES>``
  below, over the pairs in their own order (``own_*``: one pair a run) and
  sorted by bin (``sorted_*``: runs of QMAX entries, or as many as the
  queries' shared memory lets a block stage, the sort not timed),
  each checked bit for bit against the wrapper's result (every layout takes
  the same products in the same order);
- the CUDA-core ``bin_gather_kernel`` (``sskd_bin_gather`` mode 0, the
  kernel f32 rows took before), within 1e-5 of the plain version;
- the stable sort of the bins alone, and ``index_select`` + ``bmm`` (the
  yardstick).

Each time is the card's: CUDA events around 30 launches queued behind a
sleep kernel that holds the stream (``device_ms``); the wrapper also by
events at the host's pace (``ms``). At the search shapes (kb = 10) the
pairs' own layouts and the CUDA-core kernel also with the L2 cache
overwritten before each launch (``cold_device_ms``: the held time of the
overwrite and the launch, less that of the overwrite alone), as a
``/search`` finds its bins. Beside them the bounds: each distinct
bin's rows, the queries and the output once at 3.35 TB/s; the three TF32
passes at 495 TFLOP/s; the CUDA cores' FMA at 67 TFLOP/s. Prints the card's
name and power limit and one JSON line per shape, with ptxas's registers and
spills of every layout built, and writes them to
``chiprun_out/probe_gather_f32.json``.

    python3 tools/probe_gather_f32.py
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import _build  # noqa: E402
from sskd_tpu_torch.ops import topk_kernels as tk  # noqa: E402

WORK = ROOT / "build" / "probe_gather_f32"
HBM, TF32, FMA = 3.35e12, 495e12, 67e12
HOLD_CYCLES = 40_000_000  # ~20 ms of sleep: longer than queuing the launches takes
DIM = 384
# (WARPS, QMAX, STAGES) of each layout timed; own order takes one query a group
OWN = ((4, 8, 4), (4, 8, 8), (2, 8, 8), (8, 8, 6))
SORTED = ((8, 64, 3), (8, 32, 3), (8, 32, 4), (8, 16, 4), (4, 32, 4), (4, 16, 4))
LAYOUTS = {f"own_{w}w_q{q}_s{s}": (w, q, s, False) for w, q, s in OWN}
LAYOUTS.update({f"sorted_{w}w_q{q}_s{s}": (w, q, s, True) for w, q, s in SORTED})
# (rows, B, kb): an f32 index's /search, B = 256 at kb from 10 to 100 (0.3 to 3.3
# pairs a bin of the 7,813), and the evaluator's
SHAPES = ((1_000_000, 1, 10), (1_000_000, 16, 10), (1_000_000, 64, 10),
          (1_000_000, 256, 10), (1_000_000, 256, 30), (1_000_000, 256, 60),
          (1_000_000, 256, 100), (8192, 1000, 20))


def probe_source() -> str:
    cases = "\n".join(
        f"    case {i}: return gf_launch<{w}, {q}, {s}>(q, corpus, scales, bins, "
        f"{'order' if srt else 'nullptr'}, out, n_pairs, kb, dim, {q if srt else 1}, n_rows, "
        f"valid_n, st);"
        for i, (w, q, s, srt) in enumerate(LAYOUTS.values()))
    return f"""#include "bin_gather.cu"
extern "C" int probe_f32(int layout, const float* q, const float* corpus, const float* scales,
                         const int* bins, const long long* order, float* out, long n_pairs,
                         int kb, int dim, long n_rows, long valid_n, void* stream) {{
  using namespace sskd;
  cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {{
{cases}
  }}
  return (int)cudaErrorInvalidValue;
}}
"""


def held_ms(fn, iters: int = 30) -> float | None:
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


def event_ms(fn, iters: int = 30) -> float:
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


def unit_rows(n: int, d: int, g: torch.Generator) -> torch.Tensor:
    x = torch.randn(n, d, device="cuda", generator=g)
    return x / x.norm(dim=1, keepdim=True)


def checked(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather_f32: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    src, lib_path = WORK / "probe_gather_f32.cu", WORK / "probe_gather_f32.so"
    src.write_text(probe_source())
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                             str(lib_path), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _build.build_all()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    probe = lib.probe_f32
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
    record = {"nvidia_smi": smi, "layouts": {k: list(v) for k, v in LAYOUTS.items()},
              "ptxas": [line.strip() for line in log.splitlines()
                        if "registers" in line or "spill" in line or "entry function" in line]}
    print(json.dumps({"ptxas": record["ptxas"]}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    corpora = {}
    for n_rows, B, kb in SHAPES:
        if n_rows not in corpora:
            corpora.clear()
            corpora[n_rows] = unit_rows(n_rows, DIM, g)
        x = corpora[n_rows]
        q = unit_rows(B, DIM, g)
        bins = tk.topk_stable(tk.binmax_plain(q, x, None, n_rows).T, kb)[1].to(torch.int32)
        bins = bins.contiguous()
        n_pairs = B * kb
        order = tk.bin_order(bins, n_rows)
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        outs = {name: torch.empty(B, kb, 128, device="cuda") for name in LAYOUTS}
        calls = {}
        for i, (name, (_, _, _, srt)) in enumerate(LAYOUTS.items()):
            o = order if srt else None
            calls[name] = (lambda i=i, o=o, out=outs[name]: checked(probe(
                i, q.data_ptr(), x.data_ptr(), None, bins.data_ptr(),
                o.data_ptr() if o is not None else None, out.data_ptr(), n_pairs, kb, DIM,
                n_rows, n_rows, stream)))
        parent_out = torch.empty(B, kb, 128, device="cuda")
        calls["parent_cuda_core"] = lambda: checked(tk._fn("bin_gather", "sskd_bin_gather")(
            0, q.data_ptr(), None, x.data_ptr(), None, bins.data_ptr(), parent_out.data_ptr(),
            B, kb, n_rows, DIM, n_rows, stream))
        calls["wrapper"] = lambda: tk.bin_gather(q, None, x, None, bins, n_rows)
        calls["sort_int32"] = lambda: torch.sort(bins.view(-1), stable=True)
        calls["bin_order"] = lambda: tk.bin_order(bins, n_rows)
        pick = (bins.long()[:, :, None] * 128 + torch.arange(128, device="cuda")).view(-1)
        pick = pick.clamp(max=n_rows - 1)
        calls["index_select_bmm"] = lambda: torch.bmm(
            x.index_select(0, pick).view(B, kb * 128, DIM), q[:, :, None])
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        want = tk.bin_gather_plain(q, None, x, None, bins, n_rows)
        route_out = tk.bin_gather(q, None, x, None, bins, n_rows)
        torch.cuda.synchronize()
        res = {"N": n_rows, "B": B, "kb": kb, "D": DIM,
               "layout": tk.bin_gather_f32_layout(n_pairs, n_rows),
               "distinct_bins": torch.unique(bins).numel(),
               "wrapper_max_abs_err": (route_out - want).abs().max().item(),
               "parent_max_abs_err": (parent_out - want).abs().max().item()}
        for name in LAYOUTS:
            res[f"{name}_bitwise_equal_wrapper"] = bool(torch.equal(outs[name], route_out))
        times = {name: [] for name in calls}
        order_names = list(calls)
        for _ in range(2):
            for name in order_names + order_names[::-1]:
                times[name].append(held_ms(calls[name]))
        res["device_ms"] = times
        if n_rows == 1_000_000 and kb == 10:
            flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
            alone = min(held_ms(flush.zero_) for _ in range(2))
            res["cold_device_ms"] = {
                name: min(held_ms(lambda c=calls[name]: (flush.zero_(), c())) for _ in range(2))
                - alone
                for name in calls if name.startswith("own_") or name in ("parent_cuda_core",
                                                                           "wrapper")}
            del flush
        res["wrapper_ms"] = event_ms(calls["wrapper"])
        cand = n_pairs * 128
        n_bytes = res["distinct_bins"] * 128 * DIM * 4 + cand * 4 + bins.numel() * 4 + B * DIM * 4
        res["bytes_bound_ms"] = n_bytes / HBM * 1e3
        res["three_pass_ms"] = 3 * 2.0 * cand * DIM / TF32 * 1e3
        res["fma_bound_ms"] = 2.0 * cand * DIM / FMA * 1e3
        record[f"{n_rows}x{B}x{kb}"] = res
        print(json.dumps({f"{n_rows}x{B}x{kb}": res}), flush=True)
        del outs, calls, parent_out, want, route_out
    out = ROOT / "chiprun_out" / "probe_gather_f32.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
