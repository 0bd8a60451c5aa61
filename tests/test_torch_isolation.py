"""The port stands alone: no module under ``src/repro_torch/`` imports
``jax`` or anything of ``repro``, and the package imports with both
blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


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
