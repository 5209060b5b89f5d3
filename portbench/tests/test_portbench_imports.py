"""The benchmark measures ``repro_torch`` alone: no file under
``portbench/`` imports JAX or the JAX package (top-level names compared
whole), the reference imports nothing of the program, and nothing reads the
JAX-era ``benchmarks/``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py"))
HARNESS = [p for p in SOURCES if "tests" not in p.relative_to(BENCH).parts]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert not {n for n in names if n.split(".")[0] == "repro_torch"}
    # of the harness, only the seeded weights
    assert {n for n in names if n.split(".")[0] == "harness"} <= \
        {"harness.weights"}


def test_reference_reaches_no_program_module():
    """Importing the reference and the weights loads no program module."""
    code = ("import sys; sys.path.insert(0, %r); import reference.model, "
            "reference.train, harness.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", HARNESS,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_era_benchmarks(path):
    tree = ast.parse(path.read_text())
    assert "benchmarks" not in {n.split(".")[0] for n in imported(path)}
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if "benchmarks/" in s or s == "benchmarks"]


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro_torch.core", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "repro", object())
    assert run.forbidden_modules() == ["jax", "repro"]
