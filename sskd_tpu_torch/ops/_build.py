"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` compiles into its own shared library with a plain C
interface. All sources compile at once, one ``nvcc`` process each, into
``build/sskd_tpu_torch/`` at the root of the checkout. A library is named by
the hash of its source, the headers beside it and the flags, so an unchanged
source is not rebuilt. Nothing is compiled when this module is imported: the
first kernel call builds, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sskd_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuiltLibrary:
    name: str
    path: Path
    ptxas_log: str  # register / shared-memory / spill summary; "" when cached
    seconds: float  # compile wall time; 0.0 when cached


_lock = threading.Lock()
_built: dict[str, BuiltLibrary] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> dict[str, BuiltLibrary]:
    """Compile every ``csrc/*.cu`` not yet built, all ``nvcc`` processes
    started together; returns the libraries by source stem."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        pending = []
        for src in sources:
            if src.stem in _built:
                continue
            out = BUILD_DIR / f"lib{src.stem}-{_digest(src)}.so"
            if out.exists():
                _built[src.stem] = BuiltLibrary(src.stem, out, "", 0.0)
            else:
                pending.append((src, out))
        if pending:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            procs = []
            for src, out in pending:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )))
            failures = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{src.name}:\n{log}")
                    continue
                os.replace(tmp, out)
                _built[src.stem] = BuiltLibrary(
                    src.stem, out, log, time.perf_counter() - t0
                )
            if failures:
                raise RuntimeError("nvcc failed\n" + "\n".join(failures))
        return dict(_built)


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds on first use)."""
    lib = _loaded.get(stem)
    if lib is None:
        built = build_all()
        if stem not in built:
            raise RuntimeError(f"no kernel source csrc/{stem}.cu")
        with _lock:
            lib = _loaded.get(stem)
            if lib is None:
                lib = ctypes.CDLL(str(built[stem].path))
                _loaded[stem] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def check_current_device(device) -> None:
    """Raise unless ``device`` is the current CUDA device. A C entry launches
    on the current device (and on a stream of ``device``), so a wrapper
    calls this before each launch: its caller holds
    ``torch.cuda.device(device)`` where the tensors are not on the current
    device, as each shard of a sharded index does."""
    current = torch.cuda.current_device()
    if device.index != current:
        raise RuntimeError(
            f"kernel operands on {device} but the current device is cuda:{current}: "
            f"launch under torch.cuda.device({device})"
        )
