"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name; the reference imports nothing of the program."""
import ast
import sys

from benchlib import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in bench.HERE.rglob("*.py"):
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in (bench.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_forbidden_modules_by_whole_name(monkeypatch):
    for name in ("repro_torch", "repro_torchx", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert bench.forbidden_modules() == ["jaxlib", "repro"]
