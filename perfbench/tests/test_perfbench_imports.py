"""No module of the benchmark imports JAX, its relatives or the JAX
package ``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the references import nothing of the program."""
import ast
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def _tops(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    assert not set(_tops(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in set(_tops(path))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert harness.forbidden_modules() == ["repro"]
