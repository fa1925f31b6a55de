"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative
    imports left out: they stay inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if "tests" not in p.relative_to(HERE).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    found = _imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's: only whole names
    # count
    assert "repro_torch" not in FORBIDDEN
    assert _imports(HERE / "harness.py") & FORBIDDEN == set()


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "dataclasses", "math", "numpy", "torch",
                     "ttbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("ttbench."):
            assert node.module.startswith(("ttbench.reference",
                                           "ttbench.lib.shapes"))
