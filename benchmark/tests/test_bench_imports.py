"""No module of the benchmark imports JAX, Flax, the JAX package, the
chip smoke script or the repo's scripts (each import's top-level name
compared whole, so that ``mdu_tpu_torch`` is not ``mdu_tpu``), and the
plain reference imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mdu_tpu", "chip_smoke", "scripts"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_top_level_names_are_compared_whole():
    assert "mdu_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "mdu_tpu.models".split(".")[0] in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    bad = {str(f.relative_to(ROOT)): sorted(set(top_level_imports(f)) & FORBIDDEN)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "benchmark" / "reference").rglob("*.py")):
        assert "mdu_tpu_torch" not in set(top_level_imports(f)), f
        tree = ast.parse(f.read_text())
        rel = [n.module for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level > 0]
        assert all(m is None or not m.startswith("harness") for m in rel), f
