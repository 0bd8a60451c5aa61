"""Execution substrate for the event-driven pipeline.

Every component (object store, pub/sub broker, autoscaling service) is written
against the ``Scheduler`` interface, so the same wiring runs in two modes:

* ``SimScheduler``  — deterministic discrete-event simulation. Time is
  virtual; ``schedule`` pushes onto a heap and ``run`` drains it. This is how
  the Figure 2/3 experiments model institutional-scale batches (hundreds of
  containers) on a one-core host, with service times *calibrated from real
  measured conversions*.
* ``RealScheduler`` — wall-clock execution on a thread pool. Used by the
  end-to-end examples and the fault-tolerance tests that kill real workers.
"""
from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from typing import Callable

from repro_torch.analysis import racedep
from repro_torch.analysis.lockdep import TrackedLock

__all__ = ["SimScheduler", "RealScheduler", "Handle", "wall_time",
           "wall_sleep", "monotonic"]


def wall_time() -> float:
    """The single sanctioned wall-clock read (epoch seconds).

    Everything inside the event-driven spine must use its scheduler's
    ``now()`` so SimScheduler runs stay deterministic; CLI launchers and
    checkpoint stamps that genuinely want wall time route through here
    (the ``wall-clock`` lint rule allows this module only).
    """
    return time.time()


def wall_sleep(seconds: float) -> None:
    """Sanctioned wall-clock sleep — real-scheduler polls in tests only.

    Never call this from code that can run under ``SimScheduler``; use
    ``scheduler.schedule(delay, fn)`` instead.
    """
    time.sleep(seconds)


def monotonic() -> float:
    """The sanctioned monotonic read, for interval timing that genuinely
    wants wall time (batch-window deadlines under ``RealScheduler``,
    test timeouts). Spine code measuring virtual time must use its
    scheduler's ``now()``; the ``wall-clock`` lint rule rejects raw
    ``time.monotonic()``/``time.perf_counter()`` outside this module and
    ``benchmarks/``.
    """
    return time.monotonic()


class Handle:
    """Cancellation token for a scheduled callback."""

    __slots__ = ("cancelled", "_on_cancel")

    def __init__(self):
        self.cancelled = False
        self._on_cancel = None

    def cancel(self):
        self.cancelled = True
        cb, self._on_cancel = self._on_cancel, None
        if cb is not None:
            cb()


class SimScheduler:
    """Deterministic discrete-event scheduler.

    With ``seed=None`` (the default), equal-timestamp events fire in strict
    FIFO submission order — bit-for-bit the historical behaviour. With an
    integer ``seed``, each event draws a random tie-break key at schedule
    time, so equal-timestamp events fire in a seeded *permutation* of
    submission order: a legal-but-different schedule for the same program.
    ``repro_torch.analysis.schedules.explore`` re-runs a scenario across many
    seeds to hunt order-dependent bugs; ``trace`` records what actually
    fired (for the failure artifact), and re-running with the same seed
    replays the identical schedule.
    """

    def __init__(self, start: float = 0.0, seed: int | None = None,
                 record_trace: bool = False):
        self._now = start
        self._heap: list = []
        self._seq = itertools.count()
        self.seed = seed
        self._rng = None if seed is None else random.Random(seed)
        self.trace: list | None = [] if record_trace else None

    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn: Callable, *args) -> Handle:
        h = Handle()
        tie = self._rng.random() if self._rng is not None else 0.0
        heapq.heappush(self._heap, (self._now + max(delay, 0.0), tie,
                                    next(self._seq), fn, args, h))
        return h

    def run(self, until: float | None = None, max_events: int = 10_000_000):
        """Drain events (deterministically) until the heap empties, ``until``
        passes, or ``max_events`` fire. Returns the number of events fired."""
        fired = 0
        trace = self.trace
        while self._heap and fired < max_events:
            t, _, seq, fn, args, h = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            self._now = max(self._now, t)
            if not h.cancelled:
                if trace is not None:
                    trace.append((seq, round(t, 9),
                                  getattr(fn, "__qualname__",
                                          getattr(fn, "__name__", repr(fn)))))
                fn(*args)
                fired += 1
        if until is not None:
            self._now = max(self._now, until)
        return fired

    def idle(self) -> bool:
        return not self._heap


class RealScheduler:
    """Wall-clock scheduler: timers + a worker pool.

    ``schedule(0, fn)`` submits to the pool immediately; positive delays go
    through a timer thread. ``run`` blocks until quiescent (no pending timers,
    no in-flight work) or ``until`` (relative seconds) elapses.
    """

    def __init__(self, workers: int = 32):
        import concurrent.futures as cf

        self._t0 = time.monotonic()
        self._pool = cf.ThreadPoolExecutor(max_workers=workers)
        self._lock = TrackedLock("RealScheduler._lock")
        self._inflight = 0
        self._quiet = threading.Condition(self._lock)
        self._timers: set = set()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def _done(self):
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._quiet.notify_all()

    def _submit(self, fn, args, h: Handle, tok=None):
        def wrapped():
            # the pool thread inherits the submitter's happens-before
            # frontier: everything the submitter did before schedule()
            # is ordered before this event
            racedep.join_point(tok)
            try:
                if not h.cancelled:
                    fn(*args)
            finally:
                self._done()

        try:
            self._pool.submit(wrapped)
        except RuntimeError:  # scheduled after shutdown: drop the event
            self._done()

    def schedule(self, delay: float, fn: Callable, *args) -> Handle:
        h = Handle()
        tok = racedep.fork_point()
        with self._lock:
            self._inflight += 1
        if delay <= 0:
            self._submit(fn, args, h, tok)
        else:
            settled = [False]  # fire/cancel exclusion

            def fire():
                with self._lock:
                    if settled[0]:
                        return
                    settled[0] = True
                    self._timers.discard(t)
                self._submit(fn, args, h, tok)
                self._done()

            def on_cancel():
                # a cancelled timer must release both its slots immediately,
                # or run() blocks until every ack-deadline timer expires
                with self._lock:
                    if settled[0]:
                        return
                    settled[0] = True
                    self._timers.discard(t)
                t.cancel()
                self._done()  # the timer slot
                self._done()  # the (never-run) work slot

            with self._lock:
                self._inflight += 1  # the timer itself
            t = threading.Timer(delay, fire)
            t.daemon = True
            h._on_cancel = on_cancel
            with self._lock:
                self._timers.add(t)
            t.start()
        return h

    def run(self, until: float | None = None, max_events: int = 0):
        deadline = None if until is None else time.monotonic() + until
        with self._quiet:
            while self._inflight > 0:
                timeout = None
                if deadline is not None:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                self._quiet.wait(timeout=timeout if timeout else 0.25)
        return 0

    def idle(self) -> bool:
        with self._lock:
            return self._inflight == 0

    def shutdown(self):
        for t in list(self._timers):
            t.cancel()
        self._pool.shutdown(wait=False)
