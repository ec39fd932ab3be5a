"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Top-level module names
are compared whole: ``sdrtpu_torch`` is not ``sdrtpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from sdrbench import harness, run

PKG = harness.ROOT / "sdrbench"
JAX = {"jax", "jaxlib", "flax", "sdrtpu"}


def imported(path: Path) -> set:
    """Top-level names of every import in ``path``, function bodies too."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (JAX | {"sdrtpu_torch"})


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdrtpu_torch_fake.x", object())
    assert "sdrtpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sdrtpu.fake", object())
    assert run.forbidden_modules() == ["sdrtpu"]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a small size: the modules it loaded."""
    code = (
        "import sys\n"
        "from sdrbench import harness\n"
        "from sdrbench.tests.conftest import tiny\n"
        "cell = tiny(harness.load_cell('wbfm8.live'))\n"
        "out = harness.run_cell(cell, 3, 0.3, False, 'cpu', 0.0)\n"
        "assert out['correct'], out\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    mods = _modules_after(code)
    assert "sdrtpu_torch" in mods and not mods & JAX


def test_the_reference_runs_without_the_program():
    code = (
        "import sys, torch\n"
        "from sdrbench import harness\n"
        "from sdrbench.reference import wbfm\n"
        "cfg = harness.load_cell('wbfm8.batch')['config']\n"
        "cfg.update(vfos=2, fft_size=8192)\n"
        "x = torch.randn(2, 500000, dtype=torch.complex64)\n"
        "wbfm.run(cfg, x)\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    mods = _modules_after(code)
    assert not mods & (JAX | {"sdrtpu_torch"})
