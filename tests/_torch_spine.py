"""Shared pieces of the port's spine tests (``tests/test_torch_*.py``).

* ``port_lockdep_armed`` / ``port_racedep_armed``: autouse fixtures that arm
  the port's own detectors for every test of a file that imports them,
  written as ``tests/conftest.py`` writes ``repro``'s (which see only
  ``repro``'s locks and tracked state). Any violation fails the test.
* ``pinned_uids`` / ``pinned_convert``: conversions whose study and series
  UIDs derive from the slide id, so the port and ``repro`` (and a serial
  and a concurrent run) mint byte-identical studies.
* The Figure 2/3 service-time model of ``benchmarks/fig2_workflows.py`` and
  ``benchmarks/fig3_autoscaling.py`` written out over the port's pipeline
  (``benchmarks/`` imports ``repro``).
"""
from __future__ import annotations

import hashlib
import json

import pytest

from repro_torch.analysis import lockdep, racedep

CPU = "cpu"


@pytest.fixture(autouse=True)
def port_lockdep_armed():
    """Arm the port's lockdep for every test; fail on any violation."""
    det = lockdep.arm(max_hold=30.0)
    try:
        yield det
    finally:
        violations = lockdep.disarm()
        if violations:
            lines = "\n".join(f"  [{v.kind}] {v.message}" for v in violations)
            pytest.fail(
                f"port lockdep: {len(violations)} violation(s) during "
                f"test:\n{lines}", pytrace=False)


@pytest.fixture(autouse=True)
def port_racedep_armed():
    """Arm the port's data-race detector for every test; fail on any
    report."""
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
                f"port racedep: {len(violations)} data race(s) during "
                f"test:\n{lines}", pytrace=False)


def pinned_uids(slide_id: str) -> str:
    """The manifest ``"uids"`` entry minted from a slide id."""
    h = hashlib.sha256(slide_id.encode()).hexdigest()
    return json.dumps(["2.25." + str(int(h[:24], 16)),
                       "2.25." + str(int(h[24:48], 16))])


def pinned_convert(convert_wsi_to_dicom, ConvertOptions, **opt_kw):
    """A pipeline ``convert`` callable with UIDs pinned per slide id, for
    either package's converter (``opt_kw`` go to its ``ConvertOptions``)."""
    def convert(data: bytes, meta: dict) -> bytes:
        opt = ConvertOptions(manifest={"uids": pinned_uids(meta["slide_id"])},
                             **opt_kw)
        return convert_wsi_to_dicom(data, meta, options=opt)
    return convert


# ---- the Figure 2/3 model (benchmarks/fig2_workflows.py, fig3_autoscaling)
def serial_time(n: int, tau: float) -> float:
    return n * tau


def parallel_time(n: int, tau: float, workers: int = 16,
                  threads_per_convert: int = 4, vcpus: int = 16) -> float:
    """multiprocessing.Pool on one 16-vCPU VM: k concurrent conversions of
    ~4 threads each run at min(1, vcpus/(k·threads)) of solo speed."""
    total = 0.0
    remaining = n
    while remaining > 0:
        k = min(workers, remaining)
        total += tau * max(1.0, threads_per_convert * k / vcpus)
        remaining -= k
    return total


def autoscaling_time(n: int, tau: float, *, cold_start: float = 12.0,
                     max_instances: int = 100, **pipe_kw) -> float:
    """Batch completion time through the simulated port pipeline."""
    from repro_torch.core import ConversionPipeline, SimScheduler

    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=tau, cold_start=cold_start,
        max_instances=max_instances, scale_down_delay=120.0, **pipe_kw)
    t0 = sched.now()
    for i in range(n):
        pipe.ingest(f"slides/s{i}.psv", bytes([i % 251]) * 16)
    sched.run()
    assert pipe.done_count() == n
    lat = pipe.metrics.timeseries("svc.wsi2dcm.latency")
    return max(t for t, _ in lat) - t0


def minute_averages(series):
    """Time-weighted per-minute averages of a step-function timeseries."""
    end = max(t for t, _ in series)
    minutes = []
    for m in range(int(end // 60) + 2):
        lo, hi = m * 60.0, (m + 1) * 60.0
        cur = 0.0
        for t, v in series:
            if t <= lo:
                cur = v
            else:
                break
        acc, t_prev = 0.0, lo
        for t, v in series:
            if t <= lo or t >= hi:
                continue
            acc += cur * (t - t_prev)
            cur, t_prev = v, t
        acc += cur * (hi - t_prev)
        minutes.append((m, round(acc / 60.0, 1)))
    return minutes


def fig3_run(n: int = 50, tau: float = 90.0, cold_start: float = 12.0,
             scale_down_delay: float = 120.0, max_instances: int = 100,
             **pipe_kw):
    """Figure 3: instances per minute during an n-slide burst."""
    from repro_torch.core import ConversionPipeline, SimScheduler

    sched = SimScheduler()
    pipe = ConversionPipeline(sched, service_time=tau, cold_start=cold_start,
                              max_instances=max_instances,
                              scale_down_delay=scale_down_delay, **pipe_kw)
    for i in range(n):
        pipe.ingest(f"s{i}.psv", bytes([i % 251]) * 8)
    sched.run()
    return minute_averages(pipe.instance_series()), pipe
