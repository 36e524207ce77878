"""What the benchmark may import: nothing of JAX or of the JAX package
(compared by whole top-level name, since the port's name begins with the
JAX package's), nothing of the program in the reference, and none of the
repository's older measurement scripts."""

import ast
from pathlib import Path

import pytest

from benchmark.registry import HERE
from benchmark.tests import tiny  # noqa: F401

FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_old_scripts(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "ganmf_tpu", "chip_smoke", "bench", "scripts"}, tops


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        names = set(_imports(path))
        tops = {name.split(".")[0] for name in names}
        assert "ganmf_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "typing", "numpy", "scipy", "torch", "benchmark"}, (path, tops)
        assert all(n.startswith("benchmark.reference") for n in names if n.split(".")[0] == "benchmark"), names


def test_loaded_modules_compared_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "ganmf_tpu_torch_fake.models", types.ModuleType("x"))
    assert "ganmf_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ganmf_tpu.models", types.ModuleType("x"))
    assert "ganmf_tpu" in run.forbidden_modules()
