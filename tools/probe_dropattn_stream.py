"""Times of the dropattn backward's streaming kernels (``csrc/dropattn_bwd.cu``
route 2, ``"tc_stream"``) on one NVIDIA GPU.

1. At each shape below, the tree's backward (``ta.dropattn_bwd`` on its
   route) in ms a launch (CUDA events), and its device time by kernel from a
   profiled window (K1, K2 and K3 of the streaming route apart).
2. With ``--parent DIR``, a copy of an earlier commit's
   ``sskd_tpu_torch/csrc`` (``git archive <commit> sskd_tpu_torch/csrc |
   tar -x -C DIR``), that commit's ``sskd_dropattn_bwd`` entry (the
   CUDA-core dq and dk/dv pair) on the same inputs, in turns parent, tree,
   tree, parent, and the largest difference of their results.

Shapes: f32 at head dim 32 ([256, 12, 192, 32] and [32, 12, 64, 32], the
student's lengths in f32 compute), bf16 [256, 12, 512, 32] (the KD doc
tower at doc_len 512), [8, 16, 512, 64] in f32 and bf16, and [32, 16, 512,
64] f32 (the teacher at max_len 512), p = 0.1 with a random padding bias.

Prints the card's name and power limit and one JSON line per shape, and
writes them to ``chiprun_out/probe_dropattn_stream.json``.

    python3 tools/probe_dropattn_stream.py [--parent DIR]
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
from sskd_tpu_torch.ops import attention as ta  # noqa: E402

WORK = ROOT / "build" / "probe_dropattn_stream"
SHAPES = [(torch.float32, 256, 12, 192, 32), (torch.float32, 32, 12, 64, 32),
          (torch.bfloat16, 256, 12, 512, 32), (torch.float32, 8, 16, 512, 64),
          (torch.bfloat16, 8, 16, 512, 64), (torch.float32, 32, 16, 512, 64)]
P = ctypes.c_void_p


def t_ms(fn, iters: int) -> float:
    """ms a call over ``iters`` calls queued behind a held stream (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def by_kernel(fn, iters: int = 5) -> dict:
    """Device ms a call by kernel name, from one profiled window."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == cuda}


def parent_library(parent: Path) -> ctypes.CDLL:
    WORK.mkdir(parents=True, exist_ok=True)
    out = WORK / "parent_dropattn_bwd.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(parent), "-o", str(out),
                    str(parent / "dropattn_bwd.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.sskd_dropattn_bwd.restype = ctypes.c_int
    lib.sskd_dropattn_bwd.argtypes = [ctypes.c_int] + [P] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's sskd_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dropattn_stream: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all()
    lib = parent_library(Path(args.parent)) if args.parent else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype, B, h, L, d in SHAPES:
        q, k, v, go = (torch.randn(B, h, L, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        lens = torch.randint(L // 8, L + 1, (B,), device="cuda", generator=gen)
        lens[0] = L
        bias = torch.where(torch.arange(L, device="cuda")[None] < lens[:, None], 0.0,
                           torch.finfo(torch.bfloat16).min / 2).float()
        p, seed = 0.1, 5
        _, lse = ta.dropattn_fwd(q, k, v, bias, p, seed)
        iters = 3 if L * B * h >= 256 * 12 * 512 else 20
        row = {"dtype": str(dtype).split(".")[1], "shape": [B, h, L, d],
               "route": ta.dropattn_bwd_route(dtype, d, L)}

        def tree():
            return ta.dropattn_bwd(q, k, v, bias, p, seed, lse, go)

        calls = {"tree": tree}
        if lib is not None:
            outs = [torch.empty_like(q) for _ in range(3)]
            dsum = torch.empty(B, h, L, device="cuda")

            def parent():
                rc = lib.sskd_dropattn_bwd(
                    int(dtype == torch.bfloat16), *(P(t.data_ptr()) for t in
                                                    (q, k, v, bias, go, lse, dsum, *outs)),
                    B, h, L, d, d**-0.5, seed, p, 1 / (1 - p),
                    P(torch.cuda.current_stream().cuda_stream))
                assert rc == 0, rc
                return outs

            calls["parent"] = parent
        times = {name: [] for name in calls}
        for name in (["parent", "tree", "tree", "parent"] if lib is not None else ["tree"]):
            times[name].append(t_ms(calls[name], iters))
        row["ms"] = times
        row["device_ms_by_kernel"] = by_kernel(tree)
        if lib is not None:
            got, old = tree(), parent()
            torch.cuda.synchronize()
            row["max_abs_diff_vs_parent"] = max((a.float() - b.float()).abs().max().item()
                                                for a, b in zip(got, old))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, go, lse
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / "probe_dropattn_stream.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
