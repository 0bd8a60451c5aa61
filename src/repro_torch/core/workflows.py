"""The paper's Figure 2/3 experiment over the port's pipeline: serial vs
16-way parallel vs event-driven autoscaling for batches of 1/10/25/50
slides, and the container instances per minute during a 50-slide burst.

The port's copy of ``benchmarks/fig2_workflows.py`` and
``benchmarks/fig3_autoscaling.py`` (which import ``repro``), under their
names: :func:`fig3_run` is Figure 3's ``run``. Two modes:

* the discrete-event model (:func:`serial_time`, :func:`parallel_time`,
  :func:`autoscaling_time`, :func:`fig3_run`) at the paper's
  institutional scale (gigapixel slides, ~90 s a conversion on a 16-vCPU
  VM, one container per image): cold start makes autoscaling lose at
  n=1 and win at n≥10;
* :func:`measure_service_time`, the wall-clock time of one real
  conversion through the port's converter on a synthetic slide, on the
  card unless the caller asks for the CPU.
"""
from __future__ import annotations

from repro_torch.core.clock import SimScheduler, monotonic
from repro_torch.core.pipeline import ConversionPipeline

__all__ = ["BATCHES", "serial_time", "parallel_time", "autoscaling_time",
           "measure_service_time", "minute_averages", "fig3_run"]

BATCHES = (1, 10, 25, 50)


def serial_time(n: int, tau: float) -> float:
    return n * tau


def parallel_time(n: int, tau: float, workers: int = 16,
                  threads_per_convert: int = 4, vcpus: int = 16) -> float:
    """multiprocessing.Pool on one VM. The converter is internally
    multi-threaded (~``threads_per_convert`` vCPUs when run alone — the same
    assumption under τ), so k concurrent conversions on ``vcpus`` cores run at
    min(1, vcpus/(k·threads)) of solo speed. This contention is why the
    paper's Figure 2 shows autoscaling beating the 16-way pool already at
    n=10: the pool shares one VM, the containers don't."""
    total = 0.0
    remaining = n
    while remaining > 0:
        k = min(workers, remaining)
        slowdown = max(1.0, threads_per_convert * k / vcpus)
        total += tau * slowdown
        remaining -= k
    return total


def autoscaling_time(n: int, tau: float, *, cold_start: float = 12.0,
                     max_instances: int = 100, **pipe_kw) -> float:
    """Batch completion time through the simulated event-driven pipeline.

    Extra ``pipe_kw`` go to :class:`ConversionPipeline` (``fleet={...}`` /
    ``ordered_ingest=True`` run the same measurement against the
    multi-instance converter fleet).
    """
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=tau, cold_start=cold_start,
        max_instances=max_instances, scale_down_delay=120.0, **pipe_kw,
    )
    t0 = sched.now()
    for i in range(n):
        pipe.ingest(f"slides/s{i}.psv", bytes([i % 251]) * 16)
    # run to quiescence; completion time = last conversion completion
    sched.run()
    assert pipe.done_count() == n
    lat = pipe.metrics.timeseries("svc.wsi2dcm.latency")
    return max(t for t, _ in lat) - t0


def measure_service_time(side: int = 256, device: str = "cuda") -> float:
    """Wall-clock seconds of one real conversion of a ``side``² synthetic
    slide (256² tiles) on ``device``, after a warm call (kernel builds,
    first launches). A CUDA device without a card raises."""
    from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                                 convert_wsi_to_dicom)

    psv = SyntheticScanner(seed=0).scan(side, side, 256)
    # options of their own each call: a manifest holds finished levels,
    # and a reused one would skip the work
    convert_wsi_to_dicom(psv, options=ConvertOptions(device=device))  # warm
    t0 = monotonic()
    convert_wsi_to_dicom(psv, options=ConvertOptions(device=device))
    return monotonic() - t0


def minute_averages(series: list[tuple[float, float]]
                    ) -> list[tuple[int, float]]:
    """Time-weighted per-minute averages of a step-function timeseries
    (the paper's Figure 3 axis: avg container instances per minute)."""
    end = max(t for t, _ in series)
    n_min = int(end // 60) + 2
    minutes = []
    for m in range(n_min):
        lo, hi = m * 60.0, (m + 1) * 60.0
        # value at lo = last change before lo
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
    """Figure 3: an n-slide burst; returns the per-minute instance
    averages and the pipeline."""
    sched = SimScheduler()
    pipe = ConversionPipeline(sched, service_time=tau, cold_start=cold_start,
                              max_instances=max_instances,
                              scale_down_delay=scale_down_delay, **pipe_kw)
    for i in range(n):
        pipe.ingest(f"s{i}.psv", bytes([i % 251]) * 8)
    sched.run()
    return minute_averages(pipe.instance_series()), pipe
