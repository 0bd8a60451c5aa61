import os
import sys
from pathlib import Path

import pytest

# single-device CPU for tests (the dry-run manages its own device count)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro.analysis import lockdep, racedep  # noqa: E402


@pytest.fixture(autouse=True)
def _lockdep_armed(request):
    """Arm the lockdep detector for every test; fail on any violation.

    Every TrackedLock acquisition in the tree is observed while a test
    runs: lock-order inversions, callbacks invoked under a tracked lock,
    holds longer than ``max_hold`` and acquisitions inside a jit trace all
    fail the test that provoked them. Self-tests that *plant* violations
    run them inside ``lockdep.capture()``, which shadows this detector, so
    planted violations never leak here.
    """
    det = lockdep.arm(max_hold=30.0)
    try:
        yield det
    finally:
        violations = lockdep.disarm()
        if violations:
            lines = "\n".join(f"  [{v.kind}] {v.message}" for v in violations)
            pytest.fail(
                f"lockdep: {len(violations)} violation(s) during test:\n"
                f"{lines}", pytrace=False)


@pytest.fixture(autouse=True)
def _racedep_armed(request):
    """Arm the data-race detector for every test; fail on any report.

    Every read/write of the spine's ``@tracked_state`` structures is
    checked against the happens-before order (locks, condition waits,
    scheduler fork/join, tracked spawns) while a test runs. Self-tests
    that *plant* races scope them inside ``racedep.capture()``.
    """
    det = racedep.arm()
    try:
        yield det
    finally:
        violations = racedep.disarm()
        if violations:
            lines = "\n".join(f"  {v.message}\n    first:  {v.first_site}"
                              f"\n    second: {v.second_site}"
                              for v in violations)
            pytest.fail(
                f"racedep: {len(violations)} data race(s) during test:\n"
                f"{lines}", pytrace=False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips where none is present)")
