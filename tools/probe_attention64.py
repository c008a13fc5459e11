"""Timing probes behind the design of the head-dim-64 attention kernels
(``csrc/flash_attn.cu``, ``csrc/dropattn_fwd.cu``, ``csrc/dropattn_bwd.cu``)
on one NVIDIA GPU.

1. ``mma.sync`` throughput: TF32 m16n8k8 and bf16 m16n8k16, eight
   independent products a loop step, with 4, 8 and 16 warps an SM.
2. Variants of the kernels built from patched copies of ``csrc/`` under
   ``build/probe_attention64/`` (timing only: some compute wrong results on
   purpose), each timed beside the tree's own kernel on the same inputs, in
   turns: the f32 flash at [32, 16, 512, 64] with the TF32 split by
   ``cvt.rna.tf32.f32`` (its result held bit for bit against the integer
   split), with one TF32 pass, with no split, with a fast exp, with each K
   and V tile loaded once, and with the loads alone; the bf16 flash at the
   same shape with each tile loaded once and with the loads alone; the bf16
   dropattn_fwd at d = 64 past L = 64 as 8 warps (128 rows a block); the
   f32 dropattn_fwd at [32, 16, 64, 64] and [8, 16, 512, 64] with a first
   pass for the row max before the online one (two passes), with each K and
   V tile loaded once and with the loads alone; the f32 backward at [32,
   16, 64, 64] with one and with two head buffers; the bf16 flash at d = 32
   ([256, 12, 512, 32]) with signed loop counters.
3. With ``--parent DIR``, a copy of an earlier commit's
   ``sskd_tpu_torch/csrc`` (``git archive <commit> sskd_tpu_torch/csrc |
   tar -x -C DIR``): the parent's kernels beside the tree's, in turns
   parent, tree, tree, parent, and whether their results are equal bit for
   bit: the d = 32 tensor-core flash, forward and backward at the student's
   shapes; the bf16 flash at d = 64; dropattn_fwd at d = 64 in f32 and bf16
   at both shapes above.

Prints the card's name and power limit and one JSON line per probe, and
writes them to ``chiprun_out/probe_attention64.json``.

    python3 tools/probe_attention64.py [--parent DIR]
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
from sskd_tpu_torch.ops import attention as ta  # noqa: E402

WORK = ROOT / "build" / "probe_attention64"
P = ctypes.c_void_p

MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define MMA_LOOP(NAME, SHAPE, TYPES)                                                    \
  extern "C" __global__ void NAME(float* out, int n) {                                  \
    float c[8][4] = {};                                                                 \
    uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5u, b1 = 7u;                       \
    for (int i = 0; i < n; ++i) {                                                       \
      _Pragma("unroll") for (int j = 0; j < 8; ++j)                                     \
        asm volatile("mma.sync.aligned." SHAPE ".row.col.f32." TYPES ".f32 "           \
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"          \
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])       \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));   \
    }                                                                                   \
    float s = 0.f;                                                                      \
    for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];            \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                                     \
  }
MMA_LOOP(rate_tf32, "m16n8k8", "tf32.tf32")
MMA_LOOP(rate_bf16, "m16n8k16", "bf16.bf16")
extern "C" int run(int which, float* out, int blocks, int threads, int n) {
  if (which == 0) rate_tf32<<<blocks, threads>>>(out, n);
  else rate_bf16<<<blocks, threads>>>(out, n);
  return (int)cudaGetLastError();
}
"""

F32_FLASH_LOOP = "    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FF_KB);"
BF16_FLASH_LOOP = "    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FT_KB);"
MMA3 = """  mma_tf32(c_lo, al, h0, h1);
  mma_tf32(c_lo, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);"""
INT_SPLIT = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
F32_FWD_LOOP = "    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * DF32_KB);"
F32_FWD_HEAD = "  const int n_kt = (L + DF32_KB - 1) / DF32_KB;\n  for (int t = 0; t < n_kt; ++t) {"
# the f32 forward's start of its online pass, and a first pass before it that
# finds each row's max over every tile (the products of S once more), so that
# the online pass never rescales: the two-pass shape, with the same result
FWD_ONLINE_START = """  load_tile(0, 0);
  cp_async_commit();

  float qa[D / 8][4];  // q's A fragments, 8 d a step, split into hi and lo at each use
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // rows grp and grp + 8: the running max (natural units) and this thread's
  // part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
"""
FWD_TWO_PASS_START = """  float qa[D / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < (L + DF32_KB - 1) / DF32_KB; ++t) {
    load_tile(0, t * DF32_KB);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (t == 0) {
      const float* qr = s_q + (warp * 16 + grp) * LD + tig;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        qa[ks][0] = qr[ks * 8];
        qa[ks][1] = qr[8 * LD + ks * 8];
        qa[ks][2] = qr[ks * 8 + 4];
        qa[ks][3] = qr[8 * LD + ks * 8 + 4];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, s_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32_a(qa[ks], ah, al);
        const float* kr = s_k + (nt * 8 + grp) * LD + ks * 8 + tig;
        mma_3xtf32(s, s_lo, ah, al, kr[0], kr[4]);
      }
      fold_lo(s, s_lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + (e & 1);
        m[e >> 1] = fmaxf(m[e >> 1], __fadd_rn(__fmul_rn(s[e], sm_scale), s_bias[key]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  load_tile(0, 0);
  cp_async_commit();
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
"""

# name -> (source built, [(file, text, replacement)])
VARIANTS = {
    "cvt_split": ("flash_attn.cu", [("mma_common.cuh", INT_SPLIT, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 '
                                     '%0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')]),
    "one_pass": ("flash_attn.cu", [("mma_common.cuh", MMA3, "  mma_tf32(c, ah, h0, h1);")]),
    "no_split": ("flash_attn.cu", [("mma_common.cuh", INT_SPLIT, "  return __float_as_uint(x);"),
                                   ("mma_common.cuh", "  lo = tf32_rna(x - __uint_as_float(hi));",
                                    "  lo = 0u;")]),
    "fast_exp": ("flash_attn.cu", [("flash_attn.cu", "expf(", "__expf(")]),
    "tiles_once": ("flash_attn.cu", [("flash_attn.cu", F32_FLASH_LOOP, F32_FLASH_LOOP.replace("n_kt)", "2)")),
                                     ("flash_attn.cu", BF16_FLASH_LOOP, BF16_FLASH_LOOP.replace("n_kt)", "2)"))]),
    "loads_only": ("flash_attn.cu", [
        ("flash_attn.cu", "  const int n_kt = (L + FF_KB - 1) / FF_KB;\n  for (int t = 0; t < n_kt; ++t) {",
         "  const int n_kt = (L + FF_KB - 1) / FF_KB;\n  for (int t = 0; t < n_kt; ++t) {\n    if (L > 0) {"
         " if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FF_KB); cp_async_commit();"
         " cp_async_wait<1>(); __syncthreads(); qa[0][0] += s_q[tid]; continue; }"),
        ("flash_attn.cu", "  const int n_kt = (L + FT_KB - 1) / FT_KB;\n  for (int t = 0; t < n_kt; ++t) {",
         "  const int n_kt = (L + FT_KB - 1) / FT_KB;\n  for (int t = 0; t < n_kt; ++t) {\n    if (L > 0) {"
         " if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FT_KB); cp_async_commit();"
         " cp_async_wait<1>(); __syncthreads();"
         " if (t == 0) ldmatrix_x4(*reinterpret_cast<uint32_t(*)[4]>(&qa), s_q + tid * 8);"
         " continue; }")]),
    "signed_loops": ("flash_attn.cu", [
        ("flash_attn.cu", "for (unsigned i = tid; i < FT_QB * CH; i += FT_THREADS) {",
         "for (int i = tid; i < (int)(FT_QB * CH); i += FT_THREADS) {"),
        ("flash_attn.cu", "for (unsigned i = tid; i < FT_KB * CH * 2; i += FT_THREADS) {",
         "for (int i = tid; i < (int)(FT_KB * CH * 2); i += FT_THREADS) {"),
        ("flash_attn.cu", "  constexpr unsigned CH = D / 8;  // 16-byte chunks a row",
         "  constexpr int CH = D / 8;  // 16-byte chunks a row")]),
    "one_buffer": ("dropattn_bwd.cu", [("dropattn_bwd.cu", "per_sm[1] >= per_sm[0] ? 2 : 1", "1")]),
    "two_buffers": ("dropattn_bwd.cu", [("dropattn_bwd.cu", "per_sm[1] >= per_sm[0] ? 2 : 1", "2")]),
    "fwd_two_pass": ("dropattn_fwd.cu", [("dropattn_fwd.cu", FWD_ONLINE_START, FWD_TWO_PASS_START)]),
    "fwd_tiles_once": ("dropattn_fwd.cu", [("dropattn_fwd.cu", F32_FWD_LOOP,
                                            F32_FWD_LOOP.replace("n_kt)", "min(n_kt, 2))"))]),
    "fwd_bf16_w8": ("dropattn_fwd.cu", [("dropattn_fwd.cu", ": launch_tc<64, 16>(",
                                         ": launch_tc<64, 8>(")]),
    "fwd_loads_only": ("dropattn_fwd.cu", [
        ("dropattn_fwd.cu", F32_FWD_HEAD,
         F32_FWD_HEAD + "\n    if (L > 0) { if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * DF32_KB);"
         " cp_async_commit(); cp_async_wait<1>(); __syncthreads(); qa[0][0] += s_q[tid]; continue; }")]),
}


def nvcc(src: Path, out: Path, include: Path, flags=_build.NVCC_FLAGS) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *flags, "-I", str(include), "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def built(procs: dict) -> dict:
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


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
    """ms of each call, timed in turns forward then backward, ``rounds``
    times."""
    out = {name: [] for name in calls}
    order = list(calls)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name].append(round(t_ms(calls[name]), 4))
    return out


def stream() -> P:
    return P(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


def flash_call(lib, q, k, v, mask, out, new_api: bool = True):
    B, h, L, d = q.shape
    fn = lib.sskd_flash_attn_fwd_tc
    fn.restype = ctypes.c_int
    if new_api:
        fn.argtypes = [ctypes.c_int] + [P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [P]
        return lambda: fn(int(q.dtype == torch.bfloat16), ptr(q), ptr(k), ptr(v), ptr(mask),
                          ptr(out), B, h, L, d, 1.0 / d**0.5, ta._scale_log2(d), stream())
    fn.argtypes = [P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, P]
    return lambda: fn(ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), B, h, L, ta._scale_log2(d),
                      stream())


def bwd_call(lib, q, k, v, bias, g, lse, outs, p, seed, new_api: bool = True):
    B, h, L, d = q.shape
    fn = lib.sskd_dropattn_bwd_tc
    fn.restype = ctypes.c_int
    tail = [ctypes.c_float, ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
    args = [*(ptr(t) for t in (q, k, v, bias, g, lse, *outs)), B, h, L, d, 1.0 / d**0.5,
            ta._scale_log2(d), seed, p, 1.0 / (1.0 - p)]
    if new_api:
        fn.argtypes = [ctypes.c_int] + [P] * 9 + [ctypes.c_int] * 4 + tail
        return lambda: fn(int(q.dtype == torch.bfloat16), *args, stream())
    fn.argtypes = [P] * 9 + [ctypes.c_int] * 4 + tail
    return lambda: fn(*args, stream())


def fwd_call(lib, q, k, v, bias, out, lse, p, seed, tc: bool = True, new_api: bool = True):
    """A launch of ``sskd_dropattn_fwd_tc`` (the tensor-core routes; before
    this tree's API, bf16 at d = 32 only, without dtype and sm_scale) or,
    with ``tc`` False, of ``sskd_dropattn_fwd`` (the CUDA-core kernel)."""
    B, h, L, d = q.shape
    ptrs = [ptr(t) for t in (q, k, v, bias, out, lse)]
    tail = [seed, p, 1.0 / (1.0 - p)]
    dtype = int(q.dtype == torch.bfloat16)
    if not tc:
        fn = lib.sskd_dropattn_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [P] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
        return lambda: fn(dtype, *ptrs, B, h, L, d, 1.0 / d**0.5, *tail, stream())
    fn = lib.sskd_dropattn_fwd_tc
    fn.restype = ctypes.c_int
    if new_api:
        fn.argtypes = [ctypes.c_int] + [P] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
        return lambda: fn(dtype, *ptrs, B, h, L, d, 1.0 / d**0.5, ta._scale_log2(d), *tail,
                          stream())
    fn.argtypes = [P] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, P]
    return lambda: fn(*ptrs, B, h, L, d, ta._scale_log2(d), *tail, stream())


def launched(calls: dict) -> None:
    """One launch of each call, each checked and synchronised on its own."""
    for name, call in calls.items():
        rc = call()
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        torch.cuda.synchronize()


def mma_rates(work: Path) -> dict:
    src = work / "mma_rate.cu"
    src.write_text(MMA_RATE_SRC)
    lib = built({"rate": (nvcc(src, work / "mma_rate.so", work,
                                ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                                 "-Xcompiler", "-fPIC")), work / "mma_rate.so")})["rate"]
    lib.run.argtypes = [ctypes.c_int, P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for warps in (4, 8, 16):
        blocks, threads, n = n_sm * 4, 32 * warps // 4, 4096
        out = torch.empty(blocks * threads, device="cuda")
        for which, name, fma in ((0, "tf32_m16n8k8", 16 * 8 * 8), (1, "bf16_m16n8k16", 16 * 8 * 16)):
            call = lambda: lib.run(which, ptr(out), blocks, threads, n)  # noqa: E731
            if call() != 0:
                raise RuntimeError("mma rate kernel failed to launch")
            ms = t_ms(call, 3)
            flops = 2.0 * fma * 8 * n * blocks * threads / 32
            rates[f"{name}_{warps}_warps_tflops"] = flops / ms / 1e9
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier commit's sskd_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_attention64: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    procs = {}
    for name, (source, subs) in VARIANTS.items():
        tree = WORK / name
        shutil.copytree(_build.CSRC, tree)
        for file, text, repl in subs:
            body = (tree / file).read_text()
            if text not in body:
                raise RuntimeError(f"variant {name}: {text!r} not in {file}")
            (tree / file).write_text(body.replace(text, repl))
        procs[name] = (nvcc(tree / source, tree / "lib.so", tree), tree / "lib.so")
    parent = {}  # source stem -> whether its tensor-core entry takes the dtype
    if args.parent:
        for stem, entry in (("flash_attn", "sskd_flash_attn_fwd_tc"),
                            ("dropattn_bwd", "sskd_dropattn_bwd_tc"),
                            ("dropattn_fwd", "sskd_dropattn_fwd_tc")):
            src = Path(args.parent) / f"{stem}.cu"
            procs[f"parent_{stem}"] = (nvcc(src, WORK / f"parent_{stem}.so", src.parent),
                                       WORK / f"parent_{stem}.so")
            parent[stem] = f"{entry}(int dtype" in src.read_text()
    own = _build.build_all()
    libs = built(procs)
    tree_flash = ctypes.CDLL(str(own["flash_attn"].path))
    tree_bwd = ctypes.CDLL(str(own["dropattn_bwd"].path))
    tree_fwd = ctypes.CDLL(str(own["dropattn_fwd"].path))
    record = {"nvidia_smi": smi, "mma_sync": mma_rates(WORK)}
    print(json.dumps({"mma_sync": record["mma_sync"]}), flush=True)

    def emit(key, value):
        record[key] = value
        print(json.dumps({key: value}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, names in ((torch.float32, ("cvt_split", "one_pass", "no_split", "fast_exp",
                                          "tiles_once", "loads_only")),
                         (torch.bfloat16, ("tiles_once", "loads_only"))):
        q, k, v = (torch.randn(32, 16, 512, 64, device="cuda", generator=g).to(dtype)
                   for _ in range(3))
        mask = torch.ones(32, 512, dtype=torch.int32, device="cuda")
        outs = {n: torch.empty_like(q) for n in ("tree", *names)}
        calls = {"tree": flash_call(tree_flash, q, k, v, mask, outs["tree"])}
        calls.update({n: flash_call(libs[n], q, k, v, mask, outs[n]) for n in names})
        if args.parent and dtype == torch.bfloat16:
            outs["parent"] = torch.empty_like(q)
            calls["parent"] = flash_call(libs["parent_flash_attn"], q, k, v, mask, outs["parent"],
                                         parent["flash_attn"])
        launched(calls)
        res = in_turns(calls)
        if dtype == torch.float32:
            res["cvt_split_bitwise_equal"] = bool(torch.equal(outs["tree"], outs["cvt_split"]))
        else:
            if args.parent:
                res["parent_bitwise_equal"] = bool(torch.equal(outs["tree"], outs["parent"]))
        emit(f"flash_d64_{str(dtype).split('.')[1]}_ms", res)

    # dropattn_fwd at d = 64: the one-pass f32 kernel against two passes and
    # its copies, and both dtypes against the parent's CUDA-core kernel
    for B, L in ((32, 64), (8, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, 16, L, 64, device="cuda", generator=g).to(dtype)
                       for _ in range(3))
            bias = torch.zeros(B, L, device="cuda")
            names = (("fwd_two_pass", "fwd_tiles_once", "fwd_loads_only")
                     if dtype == torch.float32 else ("fwd_bf16_w8",) if L > 64 else ())
            outs = {n: (torch.empty_like(q), torch.empty(B, 16, L, device="cuda"))
                    for n in ("tree", "parent", *names)}
            calls = {"tree": fwd_call(tree_fwd, q, k, v, bias, *outs["tree"], 0.1, 5)}
            calls.update({n: fwd_call(libs[n], q, k, v, bias, *outs[n], 0.1, 5) for n in names})
            if args.parent:
                calls["parent"] = fwd_call(libs["parent_dropattn_fwd"], q, k, v, bias,
                                           *outs["parent"], 0.1, 5, tc=False)
            launched(calls)
            res = in_turns(calls)
            want, _ = ta.dropattn_fwd_plain(q, k, v, bias, 0.1, 5)
            res["tree_max_abs_err"] = (outs["tree"][0].float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                res["two_pass_max_abs_err"] = (outs["fwd_two_pass"][0] - want).abs().max().item()
            emit(f"dropattn_fwd_d64_{str(dtype).split('.')[1]}_{B}x{L}_ms", res)

    q, k, v, go = (torch.randn(32, 16, 64, 64, device="cuda", generator=g) for _ in range(4))
    bias = torch.zeros(32, 64, device="cuda")
    _, lse = ta.dropattn_fwd(q, k, v, bias, 0.1, 5)
    outs = {n: [torch.empty_like(q) for _ in range(3)] for n in ("tree", "one_buffer",
                                                                   "two_buffers")}
    calls = {"tree": bwd_call(tree_bwd, q, k, v, bias, go, lse, outs["tree"], 0.1, 5)}
    calls.update({n: bwd_call(libs[n], q, k, v, bias, go, lse, outs[n], 0.1, 5)
                  for n in ("one_buffer", "two_buffers")})
    launched(calls)
    emit("dropattn_bwd_d64_float32_ms", in_turns(calls))

    q, k, v = (torch.randn(256, 12, 512, 32, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(256, 512, dtype=torch.int32, device="cuda")
    out_t, out_s = torch.empty_like(q), torch.empty_like(q)
    calls = {"tree": flash_call(tree_flash, q, k, v, mask, out_t),
             "signed_loops": flash_call(libs["signed_loops"], q, k, v, mask, out_s)}
    if args.parent:
        out_p = torch.empty_like(q)
        calls["parent"] = flash_call(libs["parent_flash_attn"], q, k, v, mask, out_p,
                                     parent["flash_attn"])
    launched(calls)
    res = in_turns(calls)
    if args.parent:
        res["parent_bitwise_equal"] = bool(torch.equal(out_t, out_p))
    emit("flash_d32_bfloat16_ms", res)

    if args.parent:
        q, k, v, go = (torch.randn(256, 12, 192, 32, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        bias = torch.zeros(256, 192, device="cuda")
        outs = {n: (torch.empty_like(q), torch.empty(256, 12, 192, device="cuda"))
                for n in ("tree", "parent")}
        calls = {"parent": fwd_call(libs["parent_dropattn_fwd"], q, k, v, bias, *outs["parent"],
                                    0.1, 7, new_api=parent["dropattn_fwd"]),
                 "tree": fwd_call(tree_fwd, q, k, v, bias, *outs["tree"], 0.1, 7)}
        launched(calls)
        res = in_turns(calls)
        res["parent_bitwise_equal"] = all(bool(torch.equal(a, b))
                                          for a, b in zip(outs["tree"], outs["parent"]))
        emit("dropattn_fwd_d32_bfloat16_ms", res)
        lse = outs["tree"][1]
        outs_t, outs_p = ([torch.empty_like(q) for _ in range(3)] for _ in range(2))
        calls = {"parent": bwd_call(libs["parent_dropattn_bwd"], q, k, v, bias, go, lse, outs_p,
                                    0.1, 7, parent["dropattn_bwd"]),
                 "tree": bwd_call(tree_bwd, q, k, v, bias, go, lse, outs_t, 0.1, 7)}
        launched(calls)
        res = in_turns(calls)
        res["parent_bitwise_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(outs_t, outs_p))
        emit("dropattn_bwd_d32_bfloat16_ms", res)
    out = ROOT / "chiprun_out" / "probe_attention64.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
