"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either: compared on whole
top-level names (poissbox_tpu_torch begins with poissbox_tpu)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest


BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "poissbox_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def loaded(code: str) -> set[str]:
    """Top-level names of every module a fresh interpreter holds after
    running `code` from the checkout's root."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_source_imports_jax(path):
    names = top_level_imports(BENCH / path)
    assert not names & JAX, names & JAX
    if path.startswith("reference/"):
        assert "poissbox_tpu_torch" not in names


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded("import perfbench.reference.operators, perfbench.pool, perfbench.control")
    assert not mods & (JAX | {"poissbox_tpu_torch"}), mods & (JAX | {"poissbox_tpu_torch"})


def test_a_whole_run_loads_no_jax():
    mods = loaded("import sys; sys.path.insert(0, 'perfbench/tests')\n"
                  "from perfbench_helpers import cpu_run, small_cell\n"
                  "assert cpu_run(small_cell('poisson7.64.f64', 8), seconds=0.1, trace=True)['correct']")
    assert "poissbox_tpu_torch" in mods and "torch" in mods
    assert not mods & JAX, mods & JAX
