"""Nothing the benchmark runs imports JAX or the JAX package, top-level names
compared whole (the port's name begins with the JAX package's), and the
plain reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sskd_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "sskd_tpu_torch" not in tops
    mods = {n.module for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.ImportFrom) and n.module}
    assert all(not m.startswith("benchmark.") or m.startswith("benchmark.reference")
               for m in mods)


def test_whole_names_are_compared():
    from benchmark.harness.core import forbidden_modules

    import sskd_tpu_torch  # noqa: F401

    assert "sskd_tpu" not in forbidden_modules()


RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark.tests.tiny import tiny_cell
from benchmark.harness.core import forbidden_modules, run_cell
for w in ("search-e5s-msmarco8m-exact", "score-bge-mining-pairs",
          "encode-e5s-msmarco-passages", "train-e5s-kd"):
    run_cell(tiny_cell(w), 3, 0.3, False, "cpu")
print(json.dumps(sorted(forbidden_modules())))
"""


def test_a_run_of_every_entry_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
