"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imported_names(path: Path) -> set:
    """Every dotted name ``path`` imports: each module, and each name
    taken from one (``from a import b`` gives ``a`` and ``a.b``; relative
    imports left out: they stay inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    return {name.split(".")[0] for name in _imported_names(path)}


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


# a configuration family's reference and counts, and the kernels' costs,
# are reached through the family and cost modules, found by file
FAMILY_PARTS = {"ttbench.reference.dense", "ttbench.lib.flops",
                "ttbench.lib.kernel_bytes"}
FAMILY_PART_FILES = {HERE / "reference" / "dense.py",
                     HERE / "lib" / "flops.py",
                     HERE / "lib" / "kernel_bytes.py"}


DRIVERS = [p for p in SOURCES
           if p.relative_to(HERE).parts[0] not in ("families", "costs")
           and p not in FAMILY_PART_FILES]


def test_the_scan_covers_the_harness_the_check_and_the_readers():
    names = {str(p.relative_to(HERE)) for p in DRIVERS}
    assert {"harness.py", "reference/check.py",
            "metrics/step_mfu.py"} <= names
    assert {f"metrics/{p.name}" for p in (HERE / "metrics").glob("*.py")} \
        <= names
    # the scan sees each form of import
    assert _imported_names(HERE / "families" / "dense.py") & FAMILY_PARTS \
        == {"ttbench.reference.dense", "ttbench.lib.flops"}


@pytest.mark.parametrize("path", DRIVERS, ids=lambda p: str(
    p.relative_to(HERE)))
def test_only_family_and_cost_modules_import_a_familys_parts(path):
    found = _imported_names(path) & FAMILY_PARTS
    assert not found, f"{path} imports {found}"


FAMILIES = sorted(p for p in (HERE / "families").glob("*.py")
                  if not p.stem.startswith("_"))


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.stem)
def test_every_family_exports_the_contract(path):
    from ttbench.families import CONTRACT
    from ttbench.harness import _module
    mod = _module(path)
    missing = [name for name in CONTRACT if not hasattr(mod, name)]
    assert not missing, f"{path.name} lacks {missing}"
    for name in CONTRACT:
        assert callable(getattr(mod, name)), name


@pytest.mark.parametrize("path", sorted(
    p for p in (HERE / "costs").glob("*.py") if not p.stem.startswith("_")),
    ids=lambda p: p.stem)
def test_every_cost_module_exports_cost(path):
    from ttbench.harness import _module
    assert callable(_module(path).cost)
