"""The port stands alone: no JAX, no sskd_tpu, and a serving path that
imports without the JAX package's extra dependencies."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sskd_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)
BLOCKED = ("pydantic", "yaml", "prometheus_client", "msgpack", "pandas", "ml_dtypes")


def _run(code: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r} + ['chip_smoke']: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sskd_tpu'))))\n"
    )
    assert _run(code) == []


def test_no_jax_or_sskd_tpu_import_in_the_source():
    bad = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [
                f"{path.name}: {n}" for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "flax", "sskd_tpu")
            ]
    assert bad == []


def test_serving_path_imports_without_the_jax_package_dependencies():
    code = (
        "import importlib.abc, json, sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "for m in BLOCKED: sys.modules.pop(m, None)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sskd_tpu_torch.serve.app\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)))\n"
    )
    assert _run(code) == []


def test_resolve_device_refuses_a_missing_cuda(monkeypatch):
    import torch

    from sskd_tpu_torch.utils.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(asked)
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_default_to_cuda(monkeypatch):
    import torch

    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.models.student import StudentModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StudentModel("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexBuilder()


def test_training_path_imports_without_the_jax_package_dependencies():
    blocked = BLOCKED + ("jax", "jaxlib", "flax", "optax", "orbax")
    code = (
        "import importlib.abc, json, sys\n"
        f"BLOCKED = {blocked!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "for m in BLOCKED: sys.modules.pop(m, None)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sskd_tpu_torch.kd.train\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)))\n"
    )
    assert _run(code) == []


@pytest.mark.parametrize("module", [
    "sskd_tpu_torch.cli.main", "sskd_tpu_torch.utils.doctor", "sskd_tpu_torch.registry",
    "sskd_tpu_torch.keys", "sskd_tpu_torch.models.export", "sskd_tpu_torch.serve.cache",
    "sskd_tpu_torch.serve.hybrid", "sskd_tpu_torch.serve.openapi",
    "sskd_tpu_torch.serve.supervisor", "sskd_tpu_torch.utils.tracing",
    "sskd_tpu_torch.parallel.tp", "sskd_tpu_torch.parallel.distributed",
])
def test_cli_and_serving_extras_import_without_the_jax_package_dependencies(module):
    """The command line and what it reaches: no pyyaml for the YAML settings,
    no pydantic for the OpenAPI schemas, no JAX for the export's Flax tree."""
    blocked = BLOCKED + ("jax", "jaxlib", "flax", "optax", "orbax", "sskd_tpu")
    code = (
        "import importlib, importlib.abc, json, sys\n"
        f"BLOCKED = {blocked!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "for m in BLOCKED: sys.modules.pop(m, None)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module({module!r})\n"
        "from sskd_tpu_torch.config import Settings\n"
        "Settings.from_yaml('configs/service.yaml')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)))\n"
    )
    assert _run(code) == []
