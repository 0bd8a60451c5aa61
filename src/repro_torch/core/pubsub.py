"""Topic-based publish/subscribe broker with push delivery.

Implements the delivery semantics the paper relies on (and that our
fault-tolerance claims rest on):

* **at-least-once** — a message leaves the subscription only on explicit ack;
  no ack within ``ack_deadline`` ⇒ redelivery with exponential backoff,
* **dead-lettering** — after ``max_delivery_attempts`` the message is
  published to the DLQ topic instead of retried forever,
* **push flow control** — at most ``max_outstanding`` in-flight deliveries
  per subscription; excess messages queue in the backlog,
* **ordering keys** — messages sharing a key are delivered one-at-a-time in
  publish order (per-key serialization). A nacked/expired keyed message
  keeps its key reserved across the retry backoff (later messages cannot
  overtake it); the key is released — and the per-key backlog drained — on
  ack and on dead-letter, so a poison message stalls its key only until it
  dead-letters, never forever,
* **hedging** (straggler mitigation, beyond the paper's GCP defaults) — an
  optional duplicate delivery fires if no ack lands within ``hedge_after``;
  consumers are idempotent so duplicates are harmless. Whichever delivery
  acks first settles the message; a duplicate's nack is recorded but never
  touches the original delivery's outstanding entry, deadline timer, or
  retry budget,
* **budget-exempt nacks** (backpressure) — ``ctx.nack(reason,
  consume_budget=False)`` requeues the message after ``min_backoff``
  *without* incrementing the delivery attempt, so an overloaded consumer
  shedding load (HTTP-429-style) can push work back indefinitely without
  ever dead-lettering it; ordered messages keep their key reserved across
  the requeue,
* **fault injection** — an optional :class:`DeliveryFaults` schedule on a
  subscription deterministically drops, delays, or duplicates individual
  deliveries (the redelivery/dedup machinery above is what the fleet's
  fault-tolerance tests exercise through it).

The push endpoint is any callable ``endpoint(message, ctx)``; it reports
completion via ``ctx.ack()`` / ``ctx.nack()`` (asynchronously is fine).
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from collections import Counter, defaultdict, deque
from typing import Callable

from repro_torch.analysis.lockdep import TrackedLock, check_callback
from repro_torch.analysis.racedep import tracked_state
from repro_torch.core import tracing
from repro_torch.core.metrics import Metrics

__all__ = ["Message", "Topic", "Subscription", "DeliveryCtx",
           "DeliveryFaults"]

_msg_ids = itertools.count(1)


@dataclasses.dataclass
class Message:
    data: dict
    attributes: dict = dataclasses.field(default_factory=dict)
    ordering_key: str | None = None
    message_id: int = dataclasses.field(default_factory=lambda: next(_msg_ids))
    publish_time: float = 0.0


class Topic:
    def __init__(self, name: str, scheduler, metrics: Metrics | None = None):
        self.name = name
        self.scheduler = scheduler
        self.metrics = metrics or Metrics(scheduler)
        self.subscriptions: list[Subscription] = []

    def subscribe(self, sub: "Subscription"):
        self.subscriptions.append(sub)

    def publish(self, data: dict, attributes: dict | None = None,
                ordering_key: str | None = None) -> Message:
        msg = Message(data=data, attributes=attributes or {},
                      ordering_key=ordering_key,
                      publish_time=self.scheduler.now())
        if tracing.current() is not None:
            # parent priority: the publishing handler's ambient span, else
            # trace context already on the attributes (a DLQ republish
            # carries the original message's context), else this publish
            # ROOTS a new trace — the landing bucket's ambient-less
            # OBJECT_FINALIZE publish is where a slide's trace begins
            sp = tracing.start_span(
                f"topic.{self.name}.publish",
                parent=tracing.current_span(),
                parent_ctx=tracing.extract(msg.attributes),
                message_id=msg.message_id,
                object=(data or {}).get("name"))
            tracing.inject(msg.attributes, sp)
            tracing.end_span(sp)
        self.metrics.inc(f"topic.{self.name}.published")
        self.metrics.log("publish", topic=self.name, id=msg.message_id)
        for sub in self.subscriptions:
            sub._enqueue(msg)
        return msg


class DeliveryFaults:
    """Deterministic delivery-fault schedule for a :class:`Subscription`.

    Two modes, both reproducible:

    * **scripted** — :meth:`drop` / :meth:`delay` / :meth:`duplicate` rules
      matched against the message (a ``str`` matches as a substring of the
      payload's ``name`` or the ordering key; a callable is a predicate
      over the :class:`Message`) and the delivery attempt. Each rule fires
      at most ``times`` times, so a dropped message's redelivery eventually
      gets through.
    * **seeded-random** — :meth:`random` draws each delivery's fate from a
      ``random.Random(seed)``; the same seed under ``SimScheduler`` yields
      the same interleaving (the property tests' arrival-trace fuzzing).

    A *dropped* delivery never reaches the endpoint: its context stays
    outstanding until the ack deadline expires, exercising redelivery (and
    ordered-key retention). A *delayed* delivery arrives late — possibly
    after the deadline already redelivered it, exercising consumer-side
    dedup. A *duplicated* delivery pushes the same context twice; first
    settlement wins.
    """

    def __init__(self):
        self._rules: list[dict] = []
        self._rng: random.Random | None = None
        self._p = {"drop": 0.0, "duplicate": 0.0, "delay": 0.0}
        self._max_delay = 0.0
        self.injected = Counter()  # action -> times fired

    # ---- scripted rules --------------------------------------------------
    def _add(self, action: str, match, *, attempts, times, by=0.0, lag=0.0):
        self._rules.append({"action": action, "match": match,
                            "attempts": tuple(attempts), "times": times,
                            "by": by, "lag": lag})
        return self

    def drop(self, match, *, attempts=(1,), times=1):
        """Swallow matching deliveries (ack-deadline expiry redelivers)."""
        return self._add("drop", match, attempts=attempts, times=times)

    def delay(self, match, by: float, *, attempts=(1,), times=1):
        """Deliver matching messages ``by`` seconds late."""
        return self._add("delay", match, attempts=attempts, times=times,
                         by=by)

    def duplicate(self, match, *, lag: float = 0.0, attempts=(1,), times=1):
        """Push matching deliveries twice (second copy ``lag`` s later)."""
        return self._add("duplicate", match, attempts=attempts, times=times,
                         lag=lag)

    @classmethod
    def random(cls, seed: int, *, p_drop: float = 0.1,
               p_duplicate: float = 0.1, p_delay: float = 0.2,
               max_delay: float = 30.0) -> "DeliveryFaults":
        f = cls()
        f._rng = random.Random(seed)
        f._p = {"drop": p_drop, "duplicate": p_duplicate, "delay": p_delay}
        f._max_delay = max_delay
        return f

    # ---- the subscription's hook -----------------------------------------
    @staticmethod
    def _matches(match, msg: Message) -> bool:
        if callable(match):
            return bool(match(msg))
        hay = str((msg.data or {}).get("name", "")) + "\0" + \
            str(msg.ordering_key or "")
        return str(match) in hay

    def plan(self, msg: Message, attempt: int):
        """→ ``(action, deliver_delay, duplicate_lag | None)``."""
        if self._rng is not None:
            r = self._rng.random()
            if r < self._p["drop"]:
                self.injected["drop"] += 1
                return ("drop", 0.0, None)
            r -= self._p["drop"]
            if r < self._p["duplicate"]:
                self.injected["duplicate"] += 1
                return ("deliver", 0.0,
                        self._rng.uniform(0.0, self._max_delay))
            r -= self._p["duplicate"]
            if r < self._p["delay"]:
                self.injected["delay"] += 1
                return ("deliver",
                        self._rng.uniform(0.0, self._max_delay), None)
            return ("deliver", 0.0, None)
        for rule in self._rules:
            if rule["times"] <= 0 or attempt not in rule["attempts"] \
                    or not self._matches(rule["match"], msg):
                continue
            rule["times"] -= 1
            self.injected[rule["action"]] += 1
            if rule["action"] == "drop":
                return ("drop", 0.0, None)
            if rule["action"] == "delay":
                return ("deliver", rule["by"], None)
            return ("deliver", 0.0, rule["lag"])  # duplicate
        return ("deliver", 0.0, None)


class DeliveryCtx:
    """Ack handle given to push endpoints.

    Settlement (ack / nack / deadline expiry) is atomic under the owning
    subscription's lock, so concurrent real-mode workers racing a deadline
    timer resolve to exactly one outcome.

    A hedged duplicate carries ``hedge_of`` (the original delivery). It
    settles *itself* only: its ack wins the race by acking the original
    (which owns the outstanding entry and timers), and its nack is recorded
    but deliberately touches nothing — the original is still in flight with
    its own deadline and retry budget, so a failed duplicate must not pop
    the original's outstanding entry or double-schedule a retry.
    """

    def __init__(self, sub: "Subscription", msg: Message, attempt: int,
                 hedge_of: "DeliveryCtx | None" = None):
        self.sub, self.msg, self.attempt = sub, msg, attempt
        self.hedge_of = hedge_of
        self.done = False
        self.deadline_handle = None
        self.hedge_handle = None
        self.span = None  # delivery-attempt span (None when disarmed)

    def ack(self):
        if not self.sub._settle(self):
            return
        if self.hedge_of is not None:
            self.sub._on_hedge_ack(self)
        else:
            self.sub._on_ack(self)

    def nack(self, reason: str = "", *, consume_budget: bool = True):
        """Reject the delivery. ``consume_budget=False`` is the
        backpressure path: the message is requeued after ``min_backoff``
        with the *same* attempt number, so a load-shedding consumer can
        push back forever without the message ever dead-lettering."""
        if not self.sub._settle(self):
            return
        if self.hedge_of is not None:
            self.sub._on_hedge_nack(self, reason or "nack")
        else:
            self.sub._on_nack(self, reason or "nack",
                              consume_budget=consume_budget)


@tracked_state("backlog", "outstanding", "acked", "_ordered_busy",
               "_ordered_backlog")
class Subscription:
    def __init__(
        self,
        topic: Topic,
        name: str,
        endpoint: Callable[[Message, DeliveryCtx], None],
        *,
        ack_deadline: float = 600.0,
        max_delivery_attempts: int = 5,
        min_backoff: float = 10.0,
        max_backoff: float = 600.0,
        max_outstanding: int = 1000,
        hedge_after: float | None = None,
        dlq: Topic | None = None,
        faults: DeliveryFaults | None = None,
    ):
        self.topic = topic
        self.name = name
        self.endpoint = endpoint
        self.scheduler = topic.scheduler
        self.metrics = topic.metrics
        self.ack_deadline = ack_deadline
        self.max_delivery_attempts = max_delivery_attempts
        self.min_backoff, self.max_backoff = min_backoff, max_backoff
        self.max_outstanding = max_outstanding
        self.hedge_after = hedge_after
        self.dlq = dlq
        self.faults = faults
        self.backlog: deque[tuple[Message, int]] = deque()
        self.outstanding: dict[int, DeliveryCtx] = {}
        self.acked: set[int] = set()
        self._ordered_busy: set[str] = set()
        self._ordered_backlog: dict[str, deque] = defaultdict(deque)
        # guards backlog/outstanding/acked; endpoints are always invoked
        # through the scheduler (never under this lock), so concurrent
        # real-mode workers acking in parallel cannot corrupt the pump —
        # lockdep's check_callback in _push enforces exactly that
        self._lock = TrackedLock(f"Subscription[{name}]._lock",
                                 reentrant=True)
        topic.subscribe(self)

    def _settle(self, ctx: DeliveryCtx) -> bool:
        """Atomically claim a delivery's completion; False if already done."""
        with self._lock:
            if ctx.done:
                return False
            ctx.done = True
            return True

    # ---- intake ----------------------------------------------------------
    def _enqueue(self, msg: Message, attempt: int = 1, *,
                 holds_key: bool = False):
        """Queue a delivery. ``holds_key=True`` marks a retry of an ordered
        message that *already owns* its busy key (kept reserved across the
        backoff so later messages with the key cannot overtake it); a
        normal enqueue against a busy key parks in the per-key backlog."""
        with self._lock:
            key = msg.ordering_key
            if key is not None:
                if holds_key:
                    self._ordered_busy.add(key)
                elif key in self._ordered_busy:
                    self._ordered_backlog[key].append((msg, attempt))
                    return
                else:
                    self._ordered_busy.add(key)
            self.backlog.append((msg, attempt))
            self._pump()

    def _pump(self):
        # lock held
        while self.backlog and len(self.outstanding) < self.max_outstanding:
            msg, attempt = self.backlog.popleft()
            self._deliver(msg, attempt)

    # ---- delivery --------------------------------------------------------
    def _deliver(self, msg: Message, attempt: int):
        # lock held
        if msg.message_id in self.acked:  # duplicate of an acked message
            if msg.ordering_key is not None:
                # the duplicate acquired the key in _enqueue; dropping it
                # must not leave the key busy forever
                self._release_key(msg.ordering_key)
            return
        ctx = DeliveryCtx(self, msg, attempt)
        # every delivery attempt (retries included) gets its own span,
        # parented on the publish span riding the message attributes
        ctx.span = tracing.start_span(
            f"sub.{self.name}.deliver",
            parent_ctx=tracing.extract(msg.attributes),
            attempt=attempt, message_id=msg.message_id)
        self.outstanding[msg.message_id] = ctx
        self.metrics.inc(f"sub.{self.name}.deliveries")
        ctx.deadline_handle = self.scheduler.schedule(
            self.ack_deadline, self._on_deadline, ctx
        )
        if self.hedge_after is not None:
            ctx.hedge_handle = self.scheduler.schedule(
                self.hedge_after, self._on_hedge, ctx
            )
        delay, dup_lag = 0.0, None
        if self.faults is not None:
            action, delay, dup_lag = self.faults.plan(msg, attempt)
            if action == "drop":
                # swallowed: the ctx stays outstanding (ordered key held),
                # so the ack deadline expires and redelivers — exactly the
                # lost-HTTP-push failure mode the paper's retries cover
                self.metrics.inc(f"sub.{self.name}.fault_dropped")
                tracing.add_event(ctx.span, "fault.drop", attempt=attempt)
                return
            if delay:
                self.metrics.inc(f"sub.{self.name}.fault_delayed")
                tracing.add_event(ctx.span, "fault.delay", by=delay)
            if dup_lag is not None:
                # same ctx pushed twice: first settlement wins, consumers
                # must dedupe (idempotent store / fleet admission)
                self.metrics.inc(f"sub.{self.name}.fault_duplicated")
                tracing.add_event(ctx.span, "fault.duplicate", lag=dup_lag)
                self.scheduler.schedule(delay + dup_lag, self._push, ctx)
        self.scheduler.schedule(delay, self._push, ctx)

    def _push(self, ctx: DeliveryCtx):
        check_callback(f"sub.{self.name}.endpoint")
        try:
            # the delivery span is ambient while the endpoint runs, so
            # service admission / conversion / store spans parent under it
            with tracing.use_span(ctx.span):
                self.endpoint(ctx.msg, ctx)
        except Exception as e:  # endpoint crashed synchronously
            ctx.nack(f"exception: {e}")

    # ---- completion paths --------------------------------------------------
    def _release_key(self, key: str):
        """Free an ordering key and hand delivery to the next queued message.

        Called (lock held) on every settlement that ends this message's
        ownership of the key — ack, dead-letter, and acked-duplicate drop.
        A nack/deadline expiry that will be *retried* does not release: the
        retry keeps the key reserved (see ``_enqueue(holds_key=True)``) so
        per-key publish order survives the backoff.
        """
        self._ordered_busy.discard(key)
        backlog = self._ordered_backlog.get(key)
        if backlog:
            nxt, att = backlog.popleft()
            if not backlog:
                del self._ordered_backlog[key]
            self._enqueue(nxt, att)
        elif backlog is not None:
            del self._ordered_backlog[key]

    def _cleanup(self, ctx: DeliveryCtx, *, release_key: bool = True):
        with self._lock:
            self.outstanding.pop(ctx.msg.message_id, None)
            for h in (ctx.deadline_handle, ctx.hedge_handle):
                if h is not None:
                    h.cancel()
            key = ctx.msg.ordering_key
            if key is not None and release_key:
                self._release_key(key)
            self._pump()

    def _on_ack(self, ctx: DeliveryCtx):
        with self._lock:
            self.acked.add(ctx.msg.message_id)
        self.metrics.inc(f"sub.{self.name}.acks")
        # publish→ack latency is per-delivery hot-path telemetry: fold it
        # into the bounded histogram instead of an unbounded series
        self.metrics.observe(
            f"sub.{self.name}.latency",
            self.scheduler.now() - ctx.msg.publish_time,
        )
        tracing.end_span(ctx.span, status="acked")
        self._cleanup(ctx)

    def _will_retry(self, ctx: DeliveryCtx) -> bool:
        return ctx.attempt < self.max_delivery_attempts

    def _on_nack(self, ctx: DeliveryCtx, reason: str, *,
                 consume_budget: bool = True):
        self.metrics.inc(f"sub.{self.name}.nacks")
        if not consume_budget:
            # backpressure: requeue after min_backoff with the SAME attempt
            # number — shed work retries until admitted and can never
            # dead-letter. Ordered messages keep their key reserved.
            self.metrics.inc(f"sub.{self.name}.requeues")
            self.metrics.log("requeue", sub=self.name,
                             id=ctx.msg.message_id, reason=reason)
            tracing.add_event(ctx.span, "sub.requeue", reason=reason)
            tracing.end_span(ctx.span, status="requeued")
            self._cleanup(ctx, release_key=False)
            held = ctx.msg.ordering_key is not None
            self.scheduler.schedule(
                self.min_backoff,
                lambda: self._enqueue(ctx.msg, ctx.attempt, holds_key=held))
            return
        tracing.end_span(ctx.span, status="nacked", reason=reason)
        # a retried ordered message keeps its key reserved through the
        # backoff; only a dead-letter hands the key to the next message
        self._cleanup(ctx, release_key=not self._will_retry(ctx))
        self._retry(ctx, reason)

    def _on_deadline(self, ctx: DeliveryCtx):
        if not self._settle(ctx):
            return
        self.metrics.inc(f"sub.{self.name}.deadline_expired")
        tracing.end_span(ctx.span, status="deadline")
        self._cleanup(ctx, release_key=not self._will_retry(ctx))
        self._retry(ctx, "ack deadline expired")

    def _on_hedge(self, ctx: DeliveryCtx):
        """Straggler mitigation: fire a duplicate delivery, original stays."""
        with self._lock:
            if ctx.done or ctx.msg.message_id in self.acked:
                return
        self.metrics.inc(f"sub.{self.name}.hedged")
        # duplicate delivery outside the outstanding map (original still owns
        # it); hedge_of routes the duplicate's settlement (see DeliveryCtx)
        dup = DeliveryCtx(self, ctx.msg, ctx.attempt, hedge_of=ctx)
        # the hedge's span links back to the primary attempt (`hedge_of`)
        # and parents on the same publish span, so both race legs land in
        # one tree
        dup.span = tracing.start_span(
            f"sub.{self.name}.hedge",
            parent_ctx=tracing.extract(ctx.msg.attributes),
            attempt=ctx.attempt,
            hedge_of=ctx.span.span_id if ctx.span is not None else None)
        self.scheduler.schedule(0.0, self._push, dup)

    def _on_hedge_ack(self, dup: DeliveryCtx):
        """The duplicate finished first: settle the original delivery."""
        self.metrics.inc(f"sub.{self.name}.hedge_acks")
        tracing.end_span(dup.span, status="acked")
        dup.hedge_of.ack()  # no-op if the original already settled

    def _on_hedge_nack(self, dup: DeliveryCtx, reason: str):
        # deliberately nothing else: the original owns the outstanding
        # entry, deadline timer, and retry budget
        self.metrics.inc(f"sub.{self.name}.hedge_nacks")
        self.metrics.log("hedge_nack", sub=self.name,
                         id=dup.msg.message_id, reason=reason)
        tracing.end_span(dup.span, status="nacked", reason=reason)

    def _retry(self, ctx: DeliveryCtx, reason: str):
        if not self._will_retry(ctx):
            self.metrics.inc(f"sub.{self.name}.dead_lettered")
            self.metrics.log("dead_letter", sub=self.name,
                             id=ctx.msg.message_id, reason=reason)
            tracing.add_event(ctx.span, "sub.dead_letter", reason=reason)
            if self.dlq is not None:
                self.dlq.publish(ctx.msg.data,
                                 {**ctx.msg.attributes, "dlq_reason": reason})
            return
        backoff = min(self.min_backoff * 2 ** (ctx.attempt - 1),
                      self.max_backoff)
        self.metrics.log("retry", sub=self.name, id=ctx.msg.message_id,
                         attempt=ctx.attempt, backoff=backoff, reason=reason)
        tracing.add_event(ctx.span, "sub.retry", attempt=ctx.attempt,
                          backoff=backoff, reason=reason)
        held = ctx.msg.ordering_key is not None
        self.scheduler.schedule(
            backoff,
            lambda: self._enqueue(ctx.msg, ctx.attempt + 1, holds_key=held)
        )

    # ---- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "backlog": len(self.backlog),
                "outstanding": len(self.outstanding),
                "acked": len(self.acked),
                "ordered_backlog": sum(
                    len(q) for q in self._ordered_backlog.values()),
            }
