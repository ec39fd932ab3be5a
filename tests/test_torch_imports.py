"""The port imports neither JAX nor the JAX package.

Every module of ``sdrtpu_torch/`` and ``chip_smoke.py`` is parsed, and
every ``import`` and ``from ... import`` in it, at any depth (function
bodies included), is checked: none may name ``jax`` or ``sdrtpu`` (or a
submodule of either); ``sdrtpu_torch`` and relative imports are the
port's own.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "sdrtpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "sdrtpu")


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in BANNED


def _imports(tree: ast.AST):
    """(line, module name) of every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize(
    "path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_nested_imports():
    src = ("import numpy\n"
           "def f():\n"
           "    from sdrtpu.io import wav\n"
           "    import jax.numpy as jnp\n"
           "from sdrtpu_torch.io import wav\n"
           "from . import x\n")
    found = [name for _, name in _imports(ast.parse(src)) if _banned(name)]
    assert found == ["sdrtpu.io", "jax.numpy"]
