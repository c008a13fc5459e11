"""``semantic-kd doctor``: environment diagnostics (port of
sskd_tpu/utils/doctor.py).

One JSON report, the JAX package's shape (``ok``, ``required``,
``checks``; each check ``{"ok": true, ...}`` or ``{"ok": false, "error":
...}``), and its exit rule: 0 when every required check passed. The checks
are the port's own:

- ``cuda_device`` (the JAX package's ``jax_device``): the CUDA device's
  name, capability and a first matmul, or the CPU when it was asked for;
- ``native_tokenizer``: the port's binding of the C++ WordPiece core,
  built by g++ into ``build/native/``;
- ``dependencies``: torch and numpy (the JAX package lists jax, flax,
  optax, orbax and pydantic);
- ``kernel_cache`` (the JAX package's ``compile_cache``, informational):
  the kernels' build directory, ``build/sskd_tpu_torch/``;
- ``index`` (with ``--index``, required) and ``production_audit``
  (informational), as in the JAX package.
"""

from __future__ import annotations

import sys
import time


def _check(fn):
    """Run one probe: {ok, ...} or {ok: false, error}."""
    try:
        out = fn()
        return {"ok": True, **(out if isinstance(out, dict) else {"detail": out})}
    except Exception as e:  # noqa: BLE001 - a doctor reports, never raises
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def run_doctor(index_dir: str | None = None, settings=None, device: str | None = "cuda") -> dict:
    checks: dict[str, dict] = {}

    def cuda_device():
        import torch

        from sskd_tpu_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        t0 = time.perf_counter()
        x = torch.ones((8, 8), device=dev)
        float((x @ x).sum())  # waits for the device
        out = {"device": str(dev), "first_op_s": round(time.perf_counter() - t0, 2),
               "torch_cuda": torch.version.cuda}
        if dev.type == "cuda":
            out["name"] = torch.cuda.get_device_name(dev)
            out["capability"] = ".".join(map(str, torch.cuda.get_device_capability(dev)))
            out["count"] = torch.cuda.device_count()
        return out

    checks["cuda_device"] = _check(cuda_device)

    def native_tokenizer():
        from sskd_tpu_torch.tokenization.native import library_path, native_available

        if not native_available():
            raise RuntimeError(
                "C++ wordpiece core unavailable (pure-python fallback active; check "
                "native/wordpiece.cc, the g++ toolchain and SSKD_NATIVE_TOKENIZER)"
            )
        return {"library": str(library_path())}

    checks["native_tokenizer"] = _check(native_tokenizer)

    def deps():
        import numpy
        import torch

        return {"python": sys.version.split()[0],
                "versions": {"torch": torch.__version__, "numpy": numpy.__version__}}

    checks["dependencies"] = _check(deps)

    def kernel_cache():
        from sskd_tpu_torch.ops._build import BUILD_DIR

        if not BUILD_DIR.is_dir():
            return {"dir": str(BUILD_DIR), "exists": False,
                    "detail": "no kernel built yet: the first call on the card compiles "
                    "every source with nvcc"}
        return {"dir": str(BUILD_DIR), "exists": True,
                "entries": len(list(BUILD_DIR.glob("*.so")))}

    checks["kernel_cache"] = _check(kernel_cache)

    if index_dir:

        def index():
            from sskd_tpu_torch.index.builder import IndexBuilder

            b = IndexBuilder(device=device).load(index_dir)
            return {"ntotal": b.ntotal, "dtype": b.dtype, "index_type": b.index_type,
                    "embedding_dim": b.embedding_dim, "refine_m": b.refine_m}

        checks["index"] = _check(index)

    if settings is not None:

        def production():
            problems = settings.validate_for_production()
            return {"problems": problems} if not problems else {
                "detail": "informational (non-production env)", "problems": problems}

        checks["production_audit"] = _check(production)

    required = ["cuda_device", "native_tokenizer", "dependencies"]
    if index_dir:
        required.append("index")
    ok = all(checks[name]["ok"] for name in required)
    return {"ok": ok, "required": required, "checks": checks}
