"""Simulated multi-instance converter fleet — the paper's institutional
scale (Figs 2–3) as a first-class, continuously-asserted subsystem.

:class:`ConverterFleet` extends :class:`AutoscalingService` from "one global
queue drained by idle instances" to the shape the paper's Cloud-Run fleet
actually has:

* **per-instance work queues** — each instance owns a bounded local queue
  (``instance_queue_depth``, modelling push-endpoint buffering). The
  dispatcher fills the least-loaded ready instance; an instance works its
  own queue through its ``concurrency`` slots.
* **backlog-reactive scaling** — a periodic controller tick (deterministic
  under ``SimScheduler``) sizes the fleet to
  ``ceil(demand / concurrency)``, clamped to ``[min_instances,
  max_instances]``; scale-down stays with the idle-delay machinery, giving
  Figure 3's ramp → plateau → decay.
* **backpressure / load shedding** — past ``shed_backlog`` waiting requests
  (or ``shed_dlq_depth`` dead-lettered ones), new deliveries are *shed*:
  the push endpoint answers the 429-equivalent, which the broker turns
  into a budget-exempt requeue (``nack(consume_budget=False)``) — shed
  work retries until admitted and can never dead-letter, and work already
  admitted is never shed.
* **per-tenant quotas + fair scheduling** — at most ``tenant_quota``
  admitted requests per tenant (excess sheds the same way), and pending
  work is dispatched round-robin across tenants so one scanner's burst
  cannot starve another lab.
* **fault tolerance** — :meth:`kill_instance` requeues the victim's local
  queue *and* in-flight requests exactly once (to the head of their
  tenants' pending queues); the ack/ordering-key machinery upstream is
  untouched, so the slide still converts exactly once. Duplicate
  deliveries (broker hedging, injected faults, redelivery racing a slow
  ack) are deduplicated at admission by request key — a duplicate of an
  in-flight request just attaches its completion callback, a duplicate of
  a finished request completes immediately.

The fleet is API-compatible with ``AutoscalingService`` (``receive``,
``instance_count``, ``kill_instance``, ``stats``, the ``svc.{name}.*``
metrics), so ``ConversionPipeline`` swaps it in without rewiring.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable

from repro_torch.analysis.lockdep import check_callback
from repro_torch.analysis.racedep import tracked_state
from repro_torch.core import tracing
from repro_torch.core.autoscaler import AutoscalingService, Instance, _req_ids

__all__ = ["ConverterFleet", "FleetInstance"]


# deliberately NOT @tracked_state: the per-instance queue/running deques
# are fleet-private — every access (receive/_drain/_finish/_kill) holds the
# fleet's single _lock, so the detector could never pair them into a race,
# and the dispatch loop polls len(queue) thousands of times per tick (the
# disarmed-overhead gate in fleet_bench would blow its 10% budget on
# structures with no unlocked second accessor). Cross-thread misuse of the
# fleet still surfaces through its tracked coordination surface
# (_pending/_admitted/_completed/instances on ConverterFleet below).
class FleetInstance(Instance):
    __slots__ = ("queue", "running")

    def __init__(self, iid: int, ready_at: float):
        super().__init__(iid, ready_at)
        self.queue: deque = deque()  # assigned, not yet serving
        self.running: list = []      # currently in a concurrency slot


@dataclasses.dataclass
class _FleetRequest:
    payload: object
    tenant: str
    key: object  # dedupe key, e.g. (object name, generation); None = no dedupe
    arrived: float
    dones: list = dataclasses.field(default_factory=list)
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    # explicit trace handoff (see autoscaler._Request): the request span
    # survives steals and kill-requeues; hspan is the current serve attempt
    span: object = None
    hspan: object = None

    def done(self, ok):
        # every delivery that attached to this request (original + deduped
        # duplicates) gets the completion; extra acks settle as no-ops
        for cb in self.dones:
            cb(ok)


def _default_tenant_of(payload) -> str:
    if isinstance(payload, dict):
        md = payload.get("metadata") or {}
        return md.get("tenant") or payload.get("tenant") or "default"
    return "default"


def _default_key_of(payload):
    if isinstance(payload, dict) and "name" in payload:
        return (payload["name"], payload.get("generation"))
    return None


@tracked_state("_pending", "_rr", "_tenant_load", "_admitted", "_completed")
class ConverterFleet(AutoscalingService):
    instance_cls = FleetInstance

    def __init__(
        self,
        name: str,
        scheduler,
        handler: Callable,
        *,
        instance_queue_depth: int = 2,
        control_interval: float = 2.0,
        shed_backlog: int | None = None,
        shed_dlq_depth: int | None = None,
        dlq_depth: Callable[[], int] | None = None,
        tenant_quota: int | None = None,
        tenant_of: Callable | None = None,
        key_of: Callable | None = None,
        **kw,
    ):
        # fleet state must exist before super().__init__: warm min_instances
        # schedule _instance_ready → _drain, which reads it (immediately on
        # a RealScheduler pool thread)
        self.instance_queue_depth = instance_queue_depth
        self.control_interval = control_interval
        self.shed_backlog = shed_backlog
        self.shed_dlq_depth = shed_dlq_depth
        self._dlq_depth = dlq_depth
        self.tenant_quota = tenant_quota
        self._tenant_of = tenant_of or _default_tenant_of
        self._key_of = key_of or _default_key_of
        self._pending: dict[str, deque] = {}   # tenant -> FIFO of requests
        self._rr: deque[str] = deque()         # tenant round-robin rotation
        self._tenant_load: dict[str, int] = {}  # admitted & unfinished
        self._admitted: dict = {}              # key -> in-flight request
        self._completed: set = set()           # keys that finished ok
        self._tick_pending = False
        super().__init__(name, scheduler, handler, **kw)

    # ---- admission ---------------------------------------------------------
    def receive(self, payload, done: Callable, *, tenant: str | None = None,
                key=None):
        tenant = tenant or self._tenant_of(payload)
        if key is None:
            key = self._key_of(payload)
        self.metrics.inc(f"svc.{self.name}.requests")
        verdict = None
        with self._lock:
            if key is not None and key in self._completed:
                # redelivery/duplicate of finished work: the study is
                # already durably stored (idempotent writes), just ack
                self.metrics.inc(f"svc.{self.name}.duplicates")
                # annotate the *delivery* span (ambient): this attempt
                # resolved against already-finished work
                tracing.add_event(None, "fleet.duplicate", outcome="done")
                verdict = "done"
            elif key is not None and key in self._admitted:
                # duplicate of in-flight work: ride the existing request
                primary = self._admitted[key]
                primary.dones.append(done)
                self.metrics.inc(f"svc.{self.name}.duplicates")
                tracing.add_event(None, "fleet.duplicate",
                                  outcome="attached", req_id=primary.req_id)
                return
            else:
                reason = self._shed_reason(tenant)
                if reason is not None:
                    self.metrics.log("shed", svc=self.name, tenant=tenant,
                                     reason=reason)
                    tracing.add_event(None, "fleet.shed", tenant=tenant,
                                      reason=reason)
                    verdict = "shed"
            if verdict is None:
                req = _FleetRequest(payload=payload, tenant=tenant, key=key,
                                    arrived=self.scheduler.now(),
                                    dones=[done])
                req.span = tracing.start_span(
                    f"svc.{self.name}.request",
                    req_id=req.req_id, tenant=tenant)
                self._admit(req)
                self._drain()
                self._kick_controller()
                return
        # completion callbacks always run outside the lock (they re-enter
        # the broker, which may re-enter receive)
        check_callback(f"svc.{self.name}.done")
        done(True if verdict == "done" else "shed")

    def _admit(self, req: _FleetRequest):
        # lock held
        if req.tenant not in self._pending:
            self._pending[req.tenant] = deque()
            self._rr.append(req.tenant)
        self._pending[req.tenant].append(req)
        self._tenant_load[req.tenant] = \
            self._tenant_load.get(req.tenant, 0) + 1
        self._record_tenant(req.tenant)
        if req.key is not None:
            self._admitted[req.key] = req

    def _shed_reason(self, tenant: str) -> str | None:
        # lock held
        waiting = self._waiting()
        if self.shed_backlog is not None and waiting >= self.shed_backlog:
            self.metrics.inc(f"svc.{self.name}.shed")
            return f"backlog {waiting} >= shed_backlog {self.shed_backlog}"
        if self.shed_dlq_depth is not None and self._dlq_depth is not None \
                and self._dlq_depth() >= self.shed_dlq_depth:
            self.metrics.inc(f"svc.{self.name}.shed")
            return (f"dlq depth {self._dlq_depth()} >= "
                    f"shed_dlq_depth {self.shed_dlq_depth}")
        if self.tenant_quota is not None and \
                self._tenant_load.get(tenant, 0) >= self.tenant_quota:
            self.metrics.inc(f"svc.{self.name}.shed")
            self.metrics.inc(f"svc.{self.name}.shed_quota")
            return (f"tenant {tenant!r} at quota {self.tenant_quota}")
        return None

    def _record_tenant(self, tenant: str):
        self.metrics.record(f"svc.{self.name}.tenant.{tenant}.load",
                            self._tenant_load.get(tenant, 0))

    # ---- dispatch ----------------------------------------------------------
    def _waiting(self) -> int:
        # lock held: admitted but not yet in a concurrency slot
        return sum(len(q) for q in self._pending.values()) + \
            sum(len(i.queue) for i in self.instances.values() if not i.dead)

    def backlog(self) -> int:
        with self._lock:
            return self._waiting()

    def _ready_instances(self) -> list[FleetInstance]:
        # lock held; sorted by iid for a deterministic sim
        return sorted((i for i in self.instances.values()
                       if not i.dead and i.state in ("idle", "busy")),
                      key=lambda i: i.iid)

    def _pick_target(self, ready=None) -> FleetInstance | None:
        # lock held: least-loaded ready instance with queue room
        best, best_load = None, None
        for inst in self._ready_instances() if ready is None else ready:
            load = inst.active + len(inst.queue)
            if load >= self.concurrency + self.instance_queue_depth:
                continue
            if best is None or load < best_load:
                best, best_load = inst, load
        return best

    def _next_fair(self) -> _FleetRequest | None:
        # lock held: round-robin across tenants with pending work
        for _ in range(len(self._rr)):
            tenant = self._rr[0]
            self._rr.rotate(-1)
            q = self._pending.get(tenant)
            if q:
                return q.popleft()
        return None

    def _drain(self):
        # lock held. Ready-set membership (alive + idle/busy) is stable for
        # the whole drain — serving only flips active counts — so sort once
        ready = self._ready_instances()
        # 1) promote local queues into free concurrency slots
        for inst in ready:
            while inst.queue and inst.active < self.concurrency:
                self._serve(inst, inst.queue.popleft())
        # 2) fair-assign pending work to per-instance queues
        while True:
            inst = self._pick_target(ready)
            if inst is None:
                break
            req = self._next_fair()
            if req is None:
                break
            if inst.active < self.concurrency:
                self._serve(inst, req)
            else:
                inst.queue.append(req)
        # 3) work stealing: an instance with a free concurrency slot and an
        # empty local queue takes the head of the longest local queue —
        # capacity that became ready after a burst was buffered (or an
        # instance that finished early) relieves the loaded instances
        # instead of idling next to their head-of-line backlog
        while True:
            free = [i for i in ready
                    if i.active < self.concurrency and not i.queue]
            donors = [i for i in ready if i.queue]
            if not free or not donors:
                return
            donor = max(donors, key=lambda i: (len(i.queue), -i.iid))
            stolen = donor.queue.popleft()
            tracing.add_event(stolen.span, "fleet.steal",
                              src=donor.iid, dst=free[0].iid)
            self._serve(free[0], stolen)

    def _serve(self, inst: FleetInstance, req: _FleetRequest):
        inst.running.append(req)
        super()._serve(inst, req)

    def _finish(self, inst: FleetInstance, req: _FleetRequest, ok: bool):
        with self._lock:
            if not inst.dead:
                # a dead instance's requests were already requeued by
                # _kill; their accounting transfers to the requeued run
                try:
                    inst.running.remove(req)
                except ValueError:
                    pass
                self._tenant_load[req.tenant] = \
                    max(0, self._tenant_load.get(req.tenant, 1) - 1)
                self._record_tenant(req.tenant)
                if req.key is not None:
                    self._admitted.pop(req.key, None)
                    if ok:
                        self._completed.add(req.key)
        super()._finish(inst, req, ok)

    def _maybe_scale_up(self):
        # the controller tick owns scaling; base receive() is not used
        pass

    # ---- controller --------------------------------------------------------
    def _kick_controller(self):
        # lock held
        if self._tick_pending:
            return
        self._tick_pending = True
        self.scheduler.schedule(0.0, self._control_tick)

    def _control_tick(self):
        with self._lock:
            self._tick_pending = False
            waiting = self._waiting()
            demand = waiting + sum(
                i.active for i in self.instances.values() if not i.dead)
            alive = [i for i in self.instances.values()
                     if i.state != "stopped"]
            desired = min(self.max_instances,
                          max(self.min_instances,
                              math.ceil(demand / max(1, self.concurrency))))
            for _ in range(desired - len(alive)):
                self._start_instance()
            self.metrics.record(f"svc.{self.name}.backlog", waiting)
            self._drain()
            # keep ticking while there is anything to react to; a later
            # receive() re-kicks an idle controller (lets SimScheduler.run
            # reach quiescence instead of ticking forever)
            if self._waiting() > 0 or any(
                    i.state == "starting" for i in self.instances.values()):
                self._tick_pending = True
                self.scheduler.schedule(self.control_interval,
                                        self._control_tick)

    # ---- fault injection ---------------------------------------------------
    def _kill(self, inst: FleetInstance):
        # lock held (via kill_instance). Requeue the victim's local queue
        # and in-flight requests exactly once, at the head of their
        # tenants' pending queues — admission accounting (quota, dedupe
        # key) stays with the request, so nothing is lost or duplicated.
        orphans = list(inst.running) + list(inst.queue)
        inst.running.clear()
        inst.queue.clear()
        super()._kill(inst)
        for req in reversed(orphans):
            # the serve attempt dies with the instance; the request span
            # stays open and ends when the requeued run completes
            tracing.end_span(req.hspan, status="killed")
            tracing.add_event(req.span, "fleet.kill_requeue",
                              instance=inst.iid)
            if req.tenant not in self._pending:
                self._pending[req.tenant] = deque()
                self._rr.append(req.tenant)
            self._pending[req.tenant].appendleft(req)
            self.metrics.inc(f"svc.{self.name}.requeued")
        if orphans:
            self._drain()
            self._kick_controller()

    # ---- introspection -----------------------------------------------------
    def tenant_loads(self) -> dict[str, int]:
        with self._lock:
            return {t: n for t, n in self._tenant_load.items() if n}

    def stats(self) -> dict:
        with self._lock:
            return {
                "instances": len([i for i in self.instances.values()
                                  if i.state != "stopped"]),
                "waiting": self._waiting(),
                "active": sum(i.active for i in self.instances.values()
                              if not i.dead),
                "cold_starts": self.cold_starts,
                "shed": int(self.metrics.get(f"svc.{self.name}.shed")),
                "requeued": int(
                    self.metrics.get(f"svc.{self.name}.requeued")),
                "duplicates": int(
                    self.metrics.get(f"svc.{self.name}.duplicates")),
                "tenants": {t: n for t, n in self._tenant_load.items() if n},
            }
