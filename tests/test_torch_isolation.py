"""The port stands alone: no module under ``src/repro_torch/`` (the Figure
2/3 model ``core/workflows.py`` included) imports ``jax`` or anything of
``repro``, and the package imports with both blocked; the port's examples
(``examples/torch_*.py``) import none of ``jax``, ``repro`` and
``benchmarks``, and import with all three blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")
EXAMPLES = sorted((PORT.parents[1] / "examples").glob("torch_*.py"))
EXAMPLE_FORBIDDEN = FORBIDDEN + ("benchmarks",)


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_module_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


def test_package_imports_with_jax_and_repro_blocked():
    modules = sorted(".".join(p.relative_to(PORT.parent).with_suffix("")
                              .parts).removesuffix(".__init__")
                     for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parents[1],
                         env={**os.environ, "PYTHONPATH": str(PORT.parent)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_four_examples_are_scanned():
    assert [p.name for p in EXAMPLES] == [
        "torch_institutional_batch.py", "torch_quickstart.py",
        "torch_serve_llm.py", "torch_train_lm.py"]
    assert PORT / "core" / "workflows.py" in set(PORT.rglob("*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_imports_neither_jax_repro_nor_benchmarks(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & set(EXAMPLE_FORBIDDEN), roots & set(EXAMPLE_FORBIDDEN)


def test_examples_import_with_jax_repro_and_benchmarks_blocked():
    """Each example's module body (its imports; ``main`` runs only as a
    script) runs with the three blocked."""
    code = (
        "import importlib.util, sys\n"
        f"for m in {EXAMPLE_FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parents[1],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
