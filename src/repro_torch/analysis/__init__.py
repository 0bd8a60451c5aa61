"""The port's concurrency invariants, copied from ``repro.analysis``.

* :mod:`repro_torch.analysis.lockdep` — runtime lock-order instrumentation.
  Every lock of the port's spine is a
  :class:`~repro_torch.analysis.lockdep.TrackedLock`; an armed detector
  flags lock-order-inversion cycles, callbacks invoked under a lock,
  held-too-long anomalies, and locks taken inside a ``torch.compile``
  region or a CUDA graph capture.
* :mod:`repro_torch.analysis.racedep` — hybrid lockset + vector-clock
  data-race detector over the spine's ``@tracked_state`` structures.
* :mod:`repro_torch.analysis.schedules` — seeded schedule exploration
  over the ``SimScheduler`` (``explore``, ``replay``).

The port's tests arm these detectors with fixtures of their own
(``tests/test_torch_*.py``); ``repro``'s detectors do not see the port's
locks. The project lint (``repro.analysis.lint``) scans this package too.
"""
from repro_torch.analysis.lockdep import (LockDep, TrackedLock,  # noqa: F401
                                          Violation, arm, capture,
                                          check_callback, current, disarm)
from repro_torch.analysis.racedep import (RaceDep,  # noqa: F401
                                          RaceViolation, Shared, spawn,
                                          tracked_state)

__all__ = ["LockDep", "TrackedLock", "Violation", "arm", "disarm",
           "capture", "check_callback", "current",
           "RaceDep", "RaceViolation", "Shared", "spawn", "tracked_state",
           "ExplorationFailure", "explore", "replay"]

_SCHEDULES_EXPORTS = ("ExplorationFailure", "explore", "replay")


def __getattr__(name):
    # lazy: schedules is also a `python -m` entry point, and importing it
    # here eagerly would trip runpy's already-in-sys.modules warning
    if name in _SCHEDULES_EXPORTS:
        from repro_torch.analysis import schedules
        return getattr(schedules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
