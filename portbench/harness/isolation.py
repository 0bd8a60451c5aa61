"""The port runs without JAX: what to look for, and where.

:func:`loaded_jax` reads ``sys.modules`` of the running process (the run
asks it once the window has closed). :func:`imports` lists the top-level
names a source file imports, for the check that nothing under
``portbench/reference/`` imports the program. Names are compared whole by
their top-level part: ``repro_torch`` is not ``repro``.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

__all__ = ["FORBIDDEN", "loaded_jax", "imports"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def loaded_jax(modules=None) -> set[str]:
    """The forbidden top-level names among the loaded modules."""
    modules = sys.modules if modules is None else modules
    return {name.split(".", 1)[0] for name in modules} & FORBIDDEN


def imports(path: Path) -> set[str]:
    """Top-level names of every import in the file (relative imports
    left out)."""
    tree = ast.parse(Path(path).read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names
