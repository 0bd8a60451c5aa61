"""Find what a cell names, by name, in files of their own.

``BENCHMARK.json`` (beside ``portbench/``) lists the cells; a cell names
a configuration (its ``configs`` entry gives the file) and a traffic mix
(``portbench/traffic/<mix>.json``); ``portbench/cells/<cell>.json`` holds
the limits its output check compares against; each metric is read by
``portbench/metrics/<metric>.py``'s ``read(run)``; a configuration names
its plain reference, ``portbench/reference/<name>.py``. Adding any of
these is adding files and entries: no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["PORTBENCH", "Cell", "load_bench", "resolve"]

PORTBENCH = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    if not path.is_file():
        raise LookupError(f"{path} is missing")
    return json.loads(path.read_text())


def _module(path: Path, prefix: str):
    if not path.is_file():
        raise LookupError(f"{path} is missing")
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(root: Path) -> dict:
    """``root``/BENCHMARK.json (``root`` is the checkout's root)."""
    return _json(Path(root) / "BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str, root: Path, pb: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise LookupError(f"no workload named {name!r} in BENCHMARK.json "
                              f"(it has {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.model = _json(Path(root) / entry["file"])
        self.mix = _json(pb / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(pb / "cells" / f"{name}.json")
        self.reference = _module(pb / "reference" /
                                 f"{self.model['reference']}.py",
                                 "portbench_reference_")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self._pb = pb

    def reader(self, metric: str):
        """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
        return _module(self._pb / "metrics" / f"{metric}.py",
                       "portbench_metric_").read


def resolve(name: str, root: Path, pb: Path = PORTBENCH) -> Cell:
    return Cell(load_bench(root), name, Path(root), Path(pb))
