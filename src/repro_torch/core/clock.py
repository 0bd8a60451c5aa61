"""The single sanctioned wall-clock read, copied from ``repro.core.clock``.

The project lint (``wall-clock`` rule) allows ``time.time()`` only in
modules whose path ends in ``core/clock.py``: launchers that genuinely
want wall time route through here.
"""
from __future__ import annotations

import time

__all__ = ["wall_time"]


def wall_time() -> float:
    """Wall-clock time in epoch seconds."""
    return time.time()
