"""Nothing under vbnbench/ imports JAX, the JAX package or the repo's
earlier benchmark; the plain reference imports nothing of the port. Names
are compared by their whole top-level part: the port's name begins with
the JAX package's stem."""

import ast
from pathlib import Path

import pytest

from vbnbench import run

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vectorizedbayesiannetwork_tpu",
             "benchmarking", "bench", "chip_smoke"}
PORT = "vectorizedbayesiannetwork_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in ROOT.rglob("*.py") if "out" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(top_level_imports(path))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "vectorizedbayesiannetwork_tpu_like",
                        types.ModuleType("vectorizedbayesiannetwork_tpu_like"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert run.forbidden_modules() == ["jaxlib"]
