"""The port stands alone: no module of ``mimic3_tpu_torch``, no
``chip_smoke.py`` and no ``tests/test_torch_server_thread.py`` (which
``chip_smoke.py`` imports) imports JAX, the JAX training libraries
(``optax``, ``orbax``, ``flax``) or the JAX package ``mimic3_tpu``, at
module level or inside a function.  Parsed with ``ast``, so a lazy import
is caught too.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "mimic3_tpu")


def _sources():
    files = sorted((REPO / "mimic3_tpu_torch").rglob("*.py"))
    return files + [
        REPO / "chip_smoke.py",
        REPO / "tests" / "test_torch_server_thread.py",
    ]


def _imported_roots(tree: ast.AST):
    """(line, top-level package) of every absolute import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and getattr(node.func, "id", getattr(node.func, "attr", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value.split(".")[0]


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [
        f"{path.name}:{line} imports {root}"
        for line, root in _imported_roots(tree)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_the_check_sees_lazy_imports():
    """A function-level import and an ``importlib`` call both count."""
    code = (
        "def f():\n"
        "    from mimic3_tpu.config import TrainingConfig\n"
        "    import importlib\n"
        "    importlib.import_module('jax.numpy')\n"
        "from . import config\n"
    )
    roots = [root for _, root in _imported_roots(ast.parse(code))]
    assert roots.count("mimic3_tpu") == 1 and roots.count("jax") == 1
    assert "importlib" in roots


@pytest.mark.parametrize("module", ["optax", "orbax.checkpoint", "flax"])
def test_the_jax_training_libraries_are_forbidden(module):
    """The reference trains with optax and checkpoints with orbax; the
    port's trainer uses torch.optim and torch.save."""
    code = f"def f():\n    import {module}\n"
    roots = [root for _, root in _imported_roots(ast.parse(code))]
    assert roots == [module.split(".")[0]]
    assert roots[0] in FORBIDDEN
