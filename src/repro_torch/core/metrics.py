"""Shared metrics/logging — the paper's "all services log to one location,
monitored through a single dashboard".

Thread-safety (PR 8 lockdep audit): every mutation — ``inc``'s
read-modify-write on the counters dict, ``record``/``log`` appends — runs
under one :class:`TrackedLock`, because pool threads (fleet instances,
subscription settlements, store subscribers) all hit one shared ``Metrics``
concurrently; an unguarded ``counters[name] += v`` loses increments under
that interleaving. Readers either snapshot under the lock
(``timeseries``/``summary``) or go through :meth:`get`, which takes the
lock for the same reason. The lock is a leaf: nothing is called while it
is held, so it can never participate in an ordering cycle.
"""
from __future__ import annotations

import math
from collections import defaultdict

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.analysis.racedep import tracked_state
from repro_torch.core.clock import monotonic

__all__ = ["Histogram", "Metrics"]


class Histogram:
    """Log-bucketed value histogram: O(1) memory per distinct magnitude.

    Buckets are geometric with ratio ``2**0.25`` (~19% width), so p50/p95/
    p99 come back with bounded relative error while hot paths (per-delivery
    latency, per-request queue wait) stop appending to unbounded ``series``
    lists. Exact count/sum/min/max are kept alongside; percentiles report
    the bucket upper bound clamped into [min, max]. Values ``<= 0`` (sim
    queue waits are often exactly 0.0) land in a dedicated zero bucket.

    Not self-locking: instances live inside ``Metrics.histograms`` and are
    only touched under ``Metrics._lock``.
    """

    __slots__ = ("counts", "n", "total", "lo", "hi", "zeros")
    LOG2_WIDTH = 0.25  # bucket boundaries at 2**(k/4)

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.lo = math.inf
        self.hi = -math.inf
        self.zeros = 0

    def observe(self, value: float):
        self.n += 1
        self.total += value
        if value < self.lo:
            self.lo = value
        if value > self.hi:
            self.hi = value
        if value <= 0.0:
            self.zeros += 1
        else:
            b = math.floor(math.log2(value) / self.LOG2_WIDTH)
            self.counts[b] = self.counts.get(b, 0) + 1

    def percentile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        rank = q * self.n
        seen = self.zeros
        if seen >= rank:
            return min(self.lo, 0.0)
        for b in sorted(self.counts):
            seen += self.counts[b]
            if seen >= rank:
                upper = 2.0 ** ((b + 1) * self.LOG2_WIDTH)
                return max(self.lo, min(self.hi, upper))
        return self.hi

    def snapshot(self) -> dict:
        if self.n == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.n, "sum": self.total,
                "mean": self.total / self.n, "min": self.lo, "max": self.hi,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


@tracked_state("counters", "series", "events", "histograms")
class Metrics:
    def __init__(self, scheduler=None):
        self._sched = scheduler
        self._lock = TrackedLock("Metrics._lock")
        self.counters: dict[str, float] = defaultdict(float)
        self.series: dict[str, list[tuple[float, float]]] = defaultdict(list)
        self.events: list[tuple[float, str, dict]] = []
        self.histograms: dict[str, Histogram] = {}

    def _now(self) -> float:
        # real-mode (no scheduler) falls back to the sanctioned monotonic
        # clock — returning 0.0 collapsed every record()/log() timestamp
        return self._sched.now() if self._sched else monotonic()

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self.counters[name] += value

    def get(self, name: str, default: float = 0.0) -> float:
        """Read one counter under the lock (no defaultdict insertion)."""
        with self._lock:
            return self.counters.get(name, default)

    def record(self, name: str, value: float):
        """Append a (t, value) sample to a time series."""
        with self._lock:
            self.series[name].append((self._now(), value))

    def log(self, kind: str, **fields):
        with self._lock:
            self.events.append((self._now(), kind, fields))

    def observe(self, name: str, value: float):
        """Fold a sample into the named log-bucket histogram (the bounded
        replacement for hot-path ``record`` series)."""
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram()
            hist.observe(value)

    def histogram(self, name: str) -> dict:
        """Snapshot (count/sum/mean/min/max/p50/p95/p99) of one histogram."""
        with self._lock:
            hist = self.histograms.get(name)
            return hist.snapshot() if hist is not None else \
                Histogram().snapshot()

    def timeseries(self, name: str) -> list[tuple[float, float]]:
        with self._lock:
            return list(self.series[name])

    def summary(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters),
                    "series": {k: len(v) for k, v in self.series.items()},
                    "events": len(self.events),
                    "histograms": {k: h.snapshot()
                                   for k, h in self.histograms.items()}}
