"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    """Top-level names of every absolute import in a module."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    names = imported(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "json", "os", "re", "zlib",
                     "numpy", "torch"}


def test_the_walk_sees_an_import_of_each():
    assert {"torch", "repro_torch"} <= set().union(
        *(imported(p) for p in MODULES))


def test_the_check_compares_whole_names():
    from portbench import bench
    import sys
    sys.modules.setdefault("repro_torch_like", sys)   # prefix, not a match
    try:
        assert "repro_torch_like" not in bench.jax_modules()
    finally:
        sys.modules.pop("repro_torch_like", None)
