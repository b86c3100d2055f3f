"""What the benchmark's modules may load: no JAX and no JAX package
anywhere under ``mipsbench/`` (compared by whole top-level names, so
``repro_torch`` is not ``repro``), nothing of the program in the plain
reference, and no reading of the JAX package's old benchmark records."""

import ast
from pathlib import Path

import pytest

from mipsbench import harness

BENCH = Path(__file__).resolve().parent
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(BENCH).as_posix() for p in MODULES])
def test_no_jax_nor_the_jax_package(path):
    assert FORBIDDEN.isdisjoint(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert {"repro_torch", "mipsbench"}.isdisjoint(_imports(path))


def test_nothing_reads_the_old_records():
    needles = ("bench" "marks/", "BENCH" "_0", "BENCH" "_*")
    for path in MODULES:
        text = path.read_text()
        assert not any(n in text for n in needles), path


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "reprolib"]) == []
    assert harness.forbidden_modules(
        ["repro.core.index", "jax.numpy", "jaxlib", "flax.linen",
         "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]
