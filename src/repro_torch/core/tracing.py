"""Span-based distributed tracing for the event spine.

One slide's journey — landing-bucket ``OBJECT_FINALIZE`` → topic publish →
every delivery attempt (retries, hedges, budget-exempt requeues, DLQ) →
fleet admission/queue-wait/steal/kill-requeue → conversion stages → sharded
STOW → validation/inference/export fan-out — lands as ONE span tree, even
across instance kills and duplicate deliveries. Trace context rides
``Message.attributes`` (traceparent-style ``trace_id``/``span_id``): the
publisher injects its span ids into the message, the subscription extracts
them when it creates a delivery span, and everything that runs inside a
delivery or a service handler inherits an *ambient* span via a thread-local
stack, so nested instrumentation parents correctly without threading span
objects through every call signature.

Cost contract (same as lockdep/racedep): the module is DISARMED by default
and every instrumentation entry point bails after a single module-global
read (``_TRACER is None``), so the production fast path pays one load +
branch per site. Arming is explicit — :func:`arm`/:func:`disarm` or the
:class:`capture` context manager (tests, benchmarks, the dashboard smoke
batch, schedule exploration). The fleet benchmark gates the disarmed
overhead at <10% (``tracing_overhead`` in ``BENCH_fleet.json``).

Determinism: span/trace ids come from a per-tracer ``itertools.count`` (no
``random``, no wall-clock ids), and a tracer armed with ``now=sched.now``
under :class:`~repro_torch.core.clock.SimScheduler` produces bit-stable span
timings across runs — schedule-exploration failure artifacts therefore
ship reproducible traces.

Ambient context is intentionally NOT propagated across
``scheduler.schedule`` boundaries (a thread-local can't be trusted across
an event-loop hop); cross-boundary handoff is explicit — the delivery
context carries its span, service requests carry theirs — which is exactly
the places where the trace must survive retries and instance kills.
"""
from __future__ import annotations

import itertools
import threading

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.core.clock import monotonic

__all__ = [
    "Span", "Tracer", "arm", "disarm", "capture", "current",
    "start_span", "end_span", "add_event", "span", "use_span",
    "current_span", "inject", "extract",
]

# the single module-global read on the disarmed fast path
_TRACER: "Tracer | None" = None

_AMBIENT = threading.local()  # .stack: list[Span] per thread


class Span:
    """One timed operation. ``end is None`` while open; ``events`` is a
    list of ``(t, name, attrs)`` point annotations; ``attrs`` may carry a
    ``hedge_of`` link to the primary delivery's span id."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "start", "end", "status", "attrs", "events")

    def __init__(self, trace_id, span_id, parent_id, name, start, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: float | None = None
        self.status = "open"
        self.attrs: dict = attrs
        self.events: list[tuple[float, str, dict]] = []

    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start": self.start, "end": self.end, "status": self.status,
            "attrs": dict(self.attrs),
            "events": [{"t": t, "name": n, "attrs": dict(a)}
                       for t, n, a in self.events],
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.span_id}, "
                f"parent={self.parent_id}, status={self.status!r})")


class Tracer:
    """Span store. The lock is a leaf (nothing is called while held) —
    safe to take under broker/service locks, same discipline as
    ``Metrics._lock``."""

    def __init__(self, now=None):
        self._now = now if now is not None else monotonic
        self._lock = TrackedLock("Tracer._lock")
        self._ids = itertools.count(1)
        self.spans: list[Span] = []

    def now(self) -> float:
        return self._now()

    # ---- lifecycle -------------------------------------------------------
    def start(self, name: str, *, parent: Span | None = None,
              parent_ctx: tuple[str, str] | None = None,
              attrs: dict | None = None) -> Span:
        t = self._now()
        with self._lock:
            n = next(self._ids)
            sid = f"s{n:05d}"
            if parent is not None:
                trace_id, parent_id = parent.trace_id, parent.span_id
            elif parent_ctx is not None:
                trace_id, parent_id = parent_ctx
            else:
                trace_id, parent_id = f"t{n:05d}", None
            sp = Span(trace_id, sid, parent_id, name, t, attrs or {})
            self.spans.append(sp)
        return sp

    def finish(self, sp: Span, status: str, attrs: dict | None = None):
        t = self._now()
        with self._lock:
            if sp.end is None:  # idempotent: first settlement wins
                sp.end = t
                sp.status = status
            if attrs:
                sp.attrs.update(attrs)

    def event(self, sp: Span, name: str, attrs: dict | None = None):
        t = self._now()
        with self._lock:
            sp.events.append((t, name, attrs or {}))

    # ---- accessors -------------------------------------------------------
    def traces(self) -> dict[str, list[Span]]:
        """Spans grouped by trace id, in creation order."""
        with self._lock:
            spans = list(self.spans)
        out: dict[str, list[Span]] = {}
        for sp in spans:
            out.setdefault(sp.trace_id, []).append(sp)
        return out

    def spans_named(self, name: str) -> list[Span]:
        with self._lock:
            return [sp for sp in self.spans if sp.name == name]

    def export(self) -> list[dict]:
        with self._lock:
            return [sp.to_dict() for sp in self.spans]


# ---- arming --------------------------------------------------------------
def arm(now=None) -> Tracer:
    """Install a fresh tracer; ``now`` overrides the clock (pass
    ``sched.now`` for deterministic sim-time spans)."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("tracing already armed")
    _TRACER = Tracer(now=now)
    return _TRACER


def disarm() -> Tracer | None:
    """Remove the installed tracer and return it (with its spans)."""
    global _TRACER
    tr, _TRACER = _TRACER, None
    return tr


def current() -> Tracer | None:
    return _TRACER


class capture:
    """``with tracing.capture(now=sched.now) as tr:`` — arm a fresh tracer
    for the block, restoring whatever was armed before on exit (exceptions
    propagate; the captured spans stay readable on ``tr``)."""

    def __init__(self, now=None):
        self.tracer = Tracer(now=now)
        self._prev: Tracer | None = None

    def __enter__(self) -> Tracer:
        global _TRACER
        self._prev = _TRACER
        _TRACER = self.tracer
        return self.tracer

    def __exit__(self, *exc):
        global _TRACER
        _TRACER = self._prev
        return False


# ---- ambient span stack --------------------------------------------------
def current_span() -> Span | None:
    if _TRACER is None:
        return None
    st = getattr(_AMBIENT, "stack", None)
    return st[-1] if st else None


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _UseCtx:
    __slots__ = ("_span",)

    def __init__(self, sp: Span):
        self._span = sp

    def __enter__(self) -> Span:
        st = getattr(_AMBIENT, "stack", None)
        if st is None:
            st = _AMBIENT.stack = []
        st.append(self._span)
        return self._span

    def __exit__(self, *exc):
        _AMBIENT.stack.pop()
        return False


class _SpanCtx(_UseCtx):
    """Lifecycle + ambient: ends the span on exit, status ``error`` if the
    block raised."""
    __slots__ = ()

    def __exit__(self, etype, exc, tb):
        _AMBIENT.stack.pop()
        tr = _TRACER
        if tr is not None:
            tr.finish(self._span, "error" if etype is not None else "ok",
                      {"error": repr(exc)} if etype is not None else None)
        return False


def use_span(sp: Span | None):
    """Make ``sp`` the ambient parent for the block (no lifecycle)."""
    if _TRACER is None or sp is None:
        return _NULL
    return _UseCtx(sp)


def span(name: str, **attrs):
    """Start a span, make it ambient for the block, end it on exit."""
    tr = _TRACER
    if tr is None:
        return _NULL
    st = getattr(_AMBIENT, "stack", None)
    parent = st[-1] if st else None
    return _SpanCtx(tr.start(name, parent=parent, attrs=attrs))


# ---- instrumentation entry points ---------------------------------------
def start_span(name: str, *, parent: Span | None = None,
               parent_ctx: tuple[str, str] | None = None,
               **attrs) -> Span | None:
    """Open a span. Parent resolution: explicit ``parent`` span, else
    extracted ``parent_ctx`` (from message attributes), else the ambient
    span, else a new trace root."""
    tr = _TRACER
    if tr is None:
        return None
    if parent is None and parent_ctx is None:
        st = getattr(_AMBIENT, "stack", None)
        if st:
            parent = st[-1]
    return tr.start(name, parent=parent, parent_ctx=parent_ctx, attrs=attrs)


def end_span(sp: Span | None, *, status: str = "ok", **attrs):
    tr = _TRACER
    if tr is None or sp is None:
        return
    tr.finish(sp, status, attrs or None)


def add_event(sp: Span | None, name: str, **attrs):
    """Point annotation on ``sp`` (or on the ambient span when ``sp`` is
    None); dropped silently when there is no span to attach to."""
    tr = _TRACER
    if tr is None:
        return
    if sp is None:
        st = getattr(_AMBIENT, "stack", None)
        if not st:
            return
        sp = st[-1]
    tr.event(sp, name, attrs or None)


def inject(attributes: dict, sp: Span | None = None):
    """Write trace context into pub/sub message attributes."""
    tr = _TRACER
    if tr is None:
        return
    if sp is None:
        st = getattr(_AMBIENT, "stack", None)
        if not st:
            return
        sp = st[-1]
    attributes["trace_id"] = sp.trace_id
    attributes["span_id"] = sp.span_id


def extract(attributes: dict | None) -> tuple[str, str] | None:
    """Read trace context from message attributes → ``(trace_id,
    span_id)`` parent ref, or None."""
    if _TRACER is None or not attributes:
        return None
    tid = attributes.get("trace_id")
    sid = attributes.get("span_id")
    if tid is None or sid is None:
        return None
    return (tid, sid)
