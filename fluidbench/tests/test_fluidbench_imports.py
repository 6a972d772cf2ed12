"""What the benchmark loads: no module of it imports JAX, Flax or the JAX
package (``tpufluid``), and only program.py imports the program
(``tpufluid_torch``); the reference imports nothing of it. Names are
compared by their top-level part, whole: ``tpufluid_torch`` is not
``tpufluid``."""

import ast
from pathlib import Path

import pytest

from fluidbench import harness

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_module_imports(path):
    names = top_level_imports(path)
    assert not names & set(harness.FORBIDDEN), names
    if path.name != "program.py":
        assert "tpufluid_torch" not in names, "only program.py imports the program"


def test_the_import_walk_sees_every_form():
    found = top_level_imports(HERE / "program.py")
    assert {"tpufluid_torch", "torch", "numpy", "fluidbench"} <= found
    ref = set().union(*(top_level_imports(p) for p in (HERE / "reference").glob("*.py")))
    assert ref <= {"__future__", "typing", "numpy", "torch", "fluidbench"}


def test_loaded_modules_are_matched_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    for name in ("tpufluid_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpufluid.ops", types.ModuleType("tpufluid.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "tpufluid"]
