"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared
whole (``mimic3_tpu_torch`` is not ``mimic3_tpu``), lazy imports
included."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "mimic3_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imports(path: Path):
    """(top-level name, relative level) of every import in the file."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    names = {name for name, level in imports(path) if level == 0}
    assert not names & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    for name, level in imports(path):
        assert level <= 1, "the reference imports only itself"
        if level == 0:
            assert name in {"__future__", "contextlib", "dataclasses",
                            "itertools", "math", "pathlib", "typing",
                            "numpy", "torch"}, name


def test_whole_names():
    from benchmark import harness

    assert "mimic3_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert set(harness.FORBIDDEN) == JAX
