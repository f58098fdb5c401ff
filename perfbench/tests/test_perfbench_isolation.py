"""No module of the benchmark imports JAX or the JAX package, and neither
the plain reference nor the operation count imports the program under test.
Imports are compared by their whole top-level name: particlesmc_tpu_torch
begins with particlesmc_tpu."""

import ast
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "particlesmc_tpu"}
PROGRAM = "particlesmc_tpu_torch"
SOURCES = sorted(HOME.rglob("*.py"))
YARDSTICK = [p for p in SOURCES if "reference" in p.relative_to(HOME).parts or p.name == "count.py"]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert PROGRAM.startswith("particlesmc_tpu") and PROGRAM not in JAX_SIDE


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(HOME)))
def test_yardstick_does_not_import_the_program(path):
    assert PROGRAM not in top_level_imports(path)
