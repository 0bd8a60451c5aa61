"""Cloud-Run-style autoscaling container service.

Models (and in RealScheduler mode, actually executes) the paper's serverless
conversion backend:

* instances scale **0 → max_instances** on demand and back to zero,
* each new instance pays a **cold start** before it can serve,
* an instance handles ``concurrency`` requests at once (paper: 1),
* idle instances stop after ``scale_down_delay`` (Figure 3's slow decay),
* ``min_instances`` keeps warm capacity (the paper's cold-start mitigation,
  with its idle-cost trade-off),
* optional per-instance failure injection for the fault-tolerance tests.

The service exposes ``receive(request, done)`` — the push subscription's
endpoint calls it; ``done(ok)`` fires when the request finishes (the HTTP 200
of the paper). Work is supplied by a ``handler``:

* sim mode — ``handler(request) -> float`` returns the service time and the
  completion is scheduled (deterministic discrete-event execution),
* real mode — ``handler(request) -> None`` does the actual work (e.g. runs
  the port's WSI→DICOM conversion) and its wall time is the service time.

**Real-mode concurrency**: every accepted request is dispatched to the
scheduler's worker pool, so one instance really does run up to
``concurrency`` handler calls in parallel threads (the converter's heavy
regions — transform dispatch, numpy entropy coding, zlib — release the
GIL). All service state (instance table, request queue, active counts) is
guarded by one re-entrant lock; real-work handlers always run outside it
(sim-mode service-time models are called inline — sim execution is
single-threaded), and ``done`` callbacks are invoked outside it too, so
the pub/sub layer can re-enter ``receive`` without lock-ordering hazards.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable

from repro_torch.analysis.lockdep import TrackedLock, check_callback
from repro_torch.core import tracing
from repro_torch.core.metrics import Metrics

__all__ = ["AutoscalingService", "Instance"]

_req_ids = itertools.count(1)


@dataclasses.dataclass
class _Request:
    payload: object
    done: Callable[[bool], None]
    arrived: float
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    # trace handoff across scheduler hops: the request span (admission →
    # completion) and the per-serve handler span; thread-local ambience
    # cannot cross the event loop, so requests carry their spans explicitly
    span: object = None
    hspan: object = None


class Instance:
    __slots__ = ("iid", "state", "ready_at", "idle_since", "active", "dead")

    def __init__(self, iid: int, ready_at: float):
        self.iid = iid
        self.state = "starting"  # starting | idle | busy | stopped
        self.ready_at = ready_at
        self.idle_since = ready_at
        self.active = 0
        self.dead = False


# deliberately NOT @tracked_state: queue/instances are service-private —
# every access holds self._lock (receive/_drain/_finish/kill/ticks), so
# tracked accesses could never pair into a race, and the controller scans
# instances.values() thousands of times per run (the disarmed-overhead
# gate in fleet_bench budgets proxying for structures that actually cross
# a lock boundary: pubsub, metrics, pipeline and store maps, and the
# fleet's admission surface)
class AutoscalingService:
    #: Instance subclass to spawn — the fleet overrides this with an
    #: instance type that carries its own local work queue
    instance_cls = Instance

    def __init__(
        self,
        name: str,
        scheduler,
        handler: Callable,
        *,
        max_instances: int = 100,
        min_instances: int = 0,
        concurrency: int = 1,
        cold_start: float = 10.0,
        scale_down_delay: float = 60.0,
        metrics: Metrics | None = None,
        real_work: bool = False,
    ):
        self.name = name
        self.scheduler = scheduler
        self.handler = handler
        self.max_instances = max_instances
        self.min_instances = min_instances
        self.concurrency = concurrency
        self.cold_start = cold_start
        self.scale_down_delay = scale_down_delay
        self.metrics = metrics or Metrics(scheduler)
        self.real_work = real_work
        self.instances: dict[int, Instance] = {}
        self.queue: deque[_Request] = deque()
        self._iid = itertools.count(1)
        self._lock = TrackedLock(f"AutoscalingService[{name}]._lock",
                                 reentrant=True)
        self.cold_starts = 0
        with self._lock:
            for _ in range(min_instances):
                self._start_instance(warm=True)

    # ---- instance lifecycle ------------------------------------------------
    def _start_instance(self, warm: bool = False) -> Instance:
        # lock held
        iid = next(self._iid)
        delay = 0.0 if warm else self.cold_start
        inst = self.instance_cls(iid, self.scheduler.now() + delay)
        self.instances[iid] = inst
        if not warm:
            self.cold_starts += 1
            self.metrics.inc(f"svc.{self.name}.cold_starts")
        self._record_count()
        self.scheduler.schedule(delay, self._instance_ready, inst)
        return inst

    def _instance_ready(self, inst: Instance):
        with self._lock:
            if inst.state != "starting" or inst.dead:
                return
            inst.state = "idle"
            inst.idle_since = self.scheduler.now()
            self._drain()
            self._schedule_scale_down(inst)

    def _schedule_scale_down(self, inst: Instance):
        self.scheduler.schedule(self.scale_down_delay + 1e-9,
                                self._maybe_stop, inst)

    def _maybe_stop(self, inst: Instance):
        with self._lock:
            alive = [i for i in self.instances.values()
                     if i.state in ("starting", "idle", "busy")]
            if (
                inst.state == "idle"
                and self.scheduler.now() - inst.idle_since
                >= self.scale_down_delay
                and len(alive) > self.min_instances
            ):
                inst.state = "stopped"
                del self.instances[inst.iid]
                self.metrics.inc(f"svc.{self.name}.stopped")
                self._record_count()
            elif inst.state == "idle":
                self._schedule_scale_down(inst)

    def kill_instance(self, iid: int | None = None):
        """Fault injection: abruptly kill an instance (in-flight work lost)."""
        with self._lock:
            pool = [i for i in self.instances.values()
                    if i.state != "stopped"]
            if not pool:
                return None
            inst = self.instances.get(iid) if iid else pool[-1]
            if inst is None:
                return None
            self._kill(inst)
            return inst.iid

    def _kill(self, inst: Instance):
        # lock held; overridable — the fleet requeues the victim's queued
        # and in-flight work instead of losing it to the ack deadline
        inst.dead = True
        inst.state = "stopped"
        self.instances.pop(inst.iid, None)
        self.metrics.inc(f"svc.{self.name}.killed")
        self._record_count()

    def _record_count(self):
        self.metrics.record(
            f"svc.{self.name}.instances",
            len([i for i in self.instances.values() if i.state != "stopped"]),
        )

    # ---- request path --------------------------------------------------------
    def receive(self, payload, done: Callable[[bool], None]):
        req = _Request(payload, done, self.scheduler.now())
        # parented on the ambient delivery span (receive runs inside the
        # push endpoint)
        req.span = tracing.start_span(f"svc.{self.name}.request",
                                      req_id=req.req_id)
        self.metrics.inc(f"svc.{self.name}.requests")
        with self._lock:
            self.queue.append(req)
            self._drain()
            self._maybe_scale_up()

    def _maybe_scale_up(self):
        # lock held
        alive = [i for i in self.instances.values() if i.state != "stopped"]
        capacity = sum(
            self.concurrency - i.active for i in alive if not i.dead
        )
        need = len(self.queue) - capacity
        while need > 0 and len(alive) < self.max_instances:
            self._start_instance()
            alive = [i for i in self.instances.values()
                     if i.state != "stopped"]
            need -= self.concurrency

    def _drain(self):
        # lock held
        while self.queue:
            inst = self._pick_idle()
            if inst is None:
                return
            req = self.queue.popleft()
            self._serve(inst, req)

    def _pick_idle(self) -> Instance | None:
        # lock held
        best = None
        for i in self.instances.values():
            if i.state in ("idle", "busy") and not i.dead \
                    and i.active < self.concurrency:
                if best is None or i.active < best.active:
                    best = i
        return best

    def _serve(self, inst: Instance, req: _Request):
        # lock held. A real-work handler never runs here (it goes to the
        # pool via _run_real); the sim-mode handler is a service-time model
        # called inline under the lock, which is safe because sim execution
        # is single-threaded and the model must not call back into the
        # service.
        inst.active += 1
        inst.state = "busy"
        wait = self.scheduler.now() - req.arrived
        # per-request hot path: histogram, not an unbounded series
        self.metrics.observe(f"svc.{self.name}.queue_wait", wait)
        tracing.add_event(req.span, "svc.serve", instance=inst.iid,
                          queue_wait=wait)
        req.hspan = tracing.start_span(f"svc.{self.name}.handle",
                                       parent=req.span, instance=inst.iid)
        if self.real_work:
            # pool thread: up to `concurrency` of these run in parallel
            self.scheduler.schedule(0.0, self._run_real, inst, req)
        else:
            try:
                duration = float(self.handler(req.payload))
            except Exception:
                # sim-mode failure model: the request fails immediately
                # (done(False) → nack → broker retry/DLQ path), mirroring
                # the real-mode _run_real exception path
                self.scheduler.schedule(0.0, self._finish, inst, req, False)
            else:
                self.scheduler.schedule(duration, self._finish, inst, req,
                                        True)

    def _run_real(self, inst: Instance, req: _Request):
        # real-work handlers must run lock-free (PR 2's invariant; the
        # sim-mode service-time model is the one sanctioned exception)
        check_callback(f"svc.{self.name}.handler")
        try:
            # handler runs with the serve span ambient, so conversion-stage
            # spans nest under svc.<name>.handle
            with tracing.use_span(req.hspan):
                self.handler(req.payload)
            ok = True
        except Exception:
            ok = False
        self._finish(inst, req, ok)

    def _finish(self, inst: Instance, req: _Request, ok: bool):
        with self._lock:
            if inst.dead:
                return  # killed mid-flight: no ack → pub/sub redelivers
            inst.active -= 1
            if inst.active == 0:
                inst.state = "idle"
                inst.idle_since = self.scheduler.now()
                self._schedule_scale_down(inst)
            self.metrics.inc(f"svc.{self.name}.completed")
            latency = self.scheduler.now() - req.arrived
            # dual-recorded: the series carries completion *timestamps*
            # (Figure 2/3 read them), the histogram the p50/p95/p99
            self.metrics.record(f"svc.{self.name}.latency", latency)
            self.metrics.observe(f"svc.{self.name}.latency", latency)
        status = "ok" if ok else "error"
        tracing.end_span(req.hspan, status=status)
        tracing.end_span(req.span, status=status)
        # ack/nack outside the lock: it may re-enter receive() via the
        # subscription's redelivery pump
        check_callback(f"svc.{self.name}.done")
        req.done(ok)
        with self._lock:
            self._drain()

    # ---- introspection ---------------------------------------------------------
    def backlog(self) -> int:
        """Requests accepted but not yet being served."""
        with self._lock:
            return len(self.queue)

    def instance_count(self) -> int:
        with self._lock:
            return len([i for i in self.instances.values()
                        if i.state != "stopped"])

    def stats(self) -> dict:
        with self._lock:
            return {
                "instances": self.instance_count(),
                "queued": len(self.queue),
                "cold_starts": self.cold_starts,
            }
