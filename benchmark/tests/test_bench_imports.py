"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared
whole: ``audioflux_torch`` begins with ``audioflux_tpu``'s letters)."""

import ast
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "audioflux_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "audioflux_torch" not in set(imported_tops(path))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "audioflux_tpu_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtools", object())
    assert "audioflux_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "audioflux_tpu.ops", object())
    assert harness.forbidden_modules() == ["audioflux_tpu"]
