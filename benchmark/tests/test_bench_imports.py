"""No file of the benchmark imports JAX, the JAX package, ``bench.py`` or a
``chip_*.py`` script, and the reference imports nothing of the program:
top-level module names compared whole."""

from __future__ import annotations

import ast

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "benchmark").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "rho_tts_tpu", "bench"}


def _tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    tops = _tops(path)
    assert not tops & FORBIDDEN
    assert not any(t.startswith("chip_") for t in tops)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "rho_tts_tpu_torch" not in _tops(path), path
        assert not _tops(path) - {"__future__", "contextlib", "math", "typing", "torch"}, path


def test_the_guard_sees_whole_names():
    assert "rho_tts_tpu_torch" not in FORBIDDEN
    assert {t.split(".")[0] for t in ("rho_tts_tpu_torch.serving", "rho_tts_tpu.models")} \
        & FORBIDDEN == {"rho_tts_tpu"}
