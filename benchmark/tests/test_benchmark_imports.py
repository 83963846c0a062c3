"""No module under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole, since ``evreal_tpu_torch`` begins with ``evreal_tpu``."""

import ast

from benchmark.lib.spec import ROOT
from benchmark.run import FORBIDDEN, forbidden_modules


def imported(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_in_the_benchmark():
    files = list((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not imported(path) & {"jax", "jaxlib", "flax", "evreal_tpu"}, \
            path


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark/reference").rglob("*.py"):
        assert not imported(path) & {"evreal_tpu_torch", "evreal_tpu"}, path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "evreal_tpu"}
    monkeypatch.setitem(sys.modules, "evreal_tpu_torch_x",
                        types.ModuleType("evreal_tpu_torch_x"))
    assert "evreal_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert forbidden_modules() == ["jax"]
