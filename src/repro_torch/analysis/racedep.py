"""Hybrid lockset + vector-clock happens-before data-race detector.

PRs 2, 4, and 7 each fixed real interleaving bugs (hedge settlement,
callback ordering, fleet shed/settle races) by inspection, and lockdep
(PR 8) only checks lock *ordering* — not whether shared state is guarded
at all. This module turns "no data races, under any legal schedule" into a
machine-checked property, with the same disarmed-fast-path / ``arm()`` /
``capture()`` contract as :mod:`repro_torch.analysis.lockdep`:

* :class:`Shared` wraps one shared mutable structure (a dict, deque, list,
  set…). Every method that reads or mutates the underlying object records
  an access — ``(thread, source site, lockset, vector-clock epoch)`` —
  when a detector is armed; disarmed, each operation costs one
  module-global read plus the delegation call.
* :func:`tracked_state` is the class decorator that keeps a class's
  declared attributes wrapped: any assignment to a tracked name (in
  ``__init__`` or a later rebinding, e.g. ``rebuild_index`` swapping the
  whole index) is transparently replaced by a :class:`Shared` proxy.
* :class:`RaceDep` is the detector. Happens-before edges come from

  - ``TrackedLock`` acquire/release (and ``Condition`` wait/notify, which
    run through the lock's ``_release_save``/``_acquire_restore``),
  - scheduler fork/join — ``RealScheduler`` captures the submitting
    thread's clock at ``schedule()`` and the pool/timer thread joins it
    before running the event (``SimScheduler`` is single-threaded, so
    program order already covers it),
  - thread fork/join through :func:`spawn`, the tree's only sanctioned
    way to start a thread (the ``bare-thread`` lint rule),
  - pub/sub deliver→settle, which rides the two edges above: deliveries
    are scheduler events and settlements run under the subscription lock.

  A write racing a read or write from another thread is reported when the
  two accesses' locksets are **disjoint** (Eraser) *and* their clocks are
  **unordered** (no happens-before path): either condition alone marks
  benign patterns (lock-free handoff through the scheduler, reads under a
  different-but-consistent guard) as races. Reports carry both source
  sites.

Granularity is the wrapped structure: mutating an inner object fished out
of a tracked dict (``studies[uid].append(...)``) is attributed to the
``__getitem__`` read, not tracked per-element. Guard whole structures.

The detector's own mutable state is guarded by a *bare* ``threading.Lock``
on purpose — instrumenting the instrumentation would recurse; like
lockdep, this module is allowed one.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Callable

from repro_torch.analysis import lockdep as _lockdep
from repro_torch.analysis.lockdep import TrackedLock

__all__ = ["Shared", "tracked_state", "RaceDep", "RaceViolation", "arm",
           "disarm", "capture", "current", "spawn", "fork_point",
           "join_point", "set_instrumentation", "instrumentation_enabled"]

#: the armed detector, or None — one module-global read is the whole
#: disarmed fast path (gated <10% over uninstrumented in fleet_bench's
#: racedep_overhead section)
_DETECTOR: "RaceDep | None" = None

#: kill switch for the overhead benchmark's uninstrumented baseline:
#: when False, tracked_state assignments keep the raw structure (objects
#: constructed while disabled carry zero instrumentation)
_INSTRUMENT = True


def set_instrumentation(enabled: bool) -> bool:
    """Toggle wrapping of tracked attributes (benchmark baseline hook).

    Only affects objects constructed after the call; returns the previous
    setting."""
    global _INSTRUMENT
    prev, _INSTRUMENT = _INSTRUMENT, bool(enabled)
    return prev


def instrumentation_enabled() -> bool:
    return _INSTRUMENT


_OWN_FILE = __file__.rstrip("co")  # .pyc -> .py


def _site() -> str:
    """First caller frame outside this module, as ``file:line in fn``."""
    f = sys._getframe(1)
    for _ in range(8):
        if f is None:
            break
        if not f.f_code.co_filename.startswith(_OWN_FILE):
            return (f"{f.f_code.co_filename}:{f.f_lineno} "
                    f"in {f.f_code.co_name}")
        f = f.f_back
    return "<unknown>"


@dataclasses.dataclass
class RaceViolation:
    kind: str          # always "data-race"
    variable: str      # Shared name
    message: str
    first_site: str    # the earlier access
    second_site: str   # the access that exposed the race

    def __str__(self):
        return f"[{self.kind}] {self.message}"


# --------------------------------------------------------------------------
# the detector
# --------------------------------------------------------------------------
class _ThreadState:
    __slots__ = ("tid", "clock", "held")

    def __init__(self, tid: int):
        self.tid = tid
        self.clock = {tid: 1}  # vector clock, tid -> counter
        self.held: dict[int, int] = {}  # id(TrackedLock) -> recursion count


class _VarState:
    """Per-(detector, Shared) access history: one last-write epoch plus the
    last read per thread — the FastTrack-style minimum that still catches
    every write/write and read/write pair."""
    __slots__ = ("write", "reads")

    def __init__(self):
        self.write = None           # (tid, c, lockset, site)
        self.reads: dict = {}       # tid -> (c, lockset, site)


class RaceDep:
    """Lockset ∩ = ∅ AND clocks unordered ⇒ data race, both sites kept."""

    def __init__(self, *, max_violations: int = 50):
        self.max_violations = max_violations
        self.violations: list[RaceViolation] = []
        self._tls = threading.local()
        self._tids = iter(range(1, 1 << 30))
        # bare lock by design (see module docstring): the detector must
        # not instrument itself  # lint: allow(bare-lock)
        self._mu = threading.Lock()
        self._lock_clocks: dict[int, dict] = {}  # id(lock) -> clock
        self._reported: set = set()              # (var, siteA, siteB) dedupe
        self.accesses = 0

    # ---- per-thread state -------------------------------------------------
    def _state(self) -> _ThreadState:
        try:
            return self._tls.state
        except AttributeError:
            with self._mu:
                st = _ThreadState(next(self._tids))
            self._tls.state = st
            return st

    # ---- happens-before edges --------------------------------------------
    def _join_lock(self, st: _ThreadState, key: int):
        with self._mu:
            lc = self._lock_clocks.get(key)
            if lc:
                clock = st.clock
                for t, c in lc.items():
                    if clock.get(t, 0) < c:
                        clock[t] = c

    def _publish_lock(self, st: _ThreadState, key: int):
        with self._mu:
            lc = self._lock_clocks.setdefault(key, {})
            for t, c in st.clock.items():
                if lc.get(t, 0) < c:
                    lc[t] = c
        st.clock[st.tid] += 1

    def _on_lock_acquired(self, lock: TrackedLock):
        st = self._state()
        key = id(lock)
        n = st.held.get(key, 0)
        st.held[key] = n + 1
        if n == 0:  # outermost acquisition: join the lock's clock
            self._join_lock(st, key)

    def _on_lock_released(self, lock: TrackedLock):
        st = self._state()
        key = id(lock)
        n = st.held.get(key, 0)
        if n > 1:  # inner reentrant release: lock still held
            st.held[key] = n - 1
            return
        st.held.pop(key, None)
        self._publish_lock(st, key)

    def _on_wait_release(self, lock: TrackedLock) -> int | None:
        """Condition.wait fully released the lock (any recursion depth);
        returns the count to restore on wakeup."""
        st = self._state()
        count = st.held.pop(id(lock), None)
        self._publish_lock(st, id(lock))
        return count

    def _on_wait_acquire(self, lock: TrackedLock, count: int | None):
        st = self._state()
        st.held[id(lock)] = count if count else 1
        self._join_lock(st, id(lock))

    def fork(self) -> dict:
        """Snapshot the calling thread's clock (a message/submit token)."""
        st = self._state()
        snap = dict(st.clock)
        st.clock[st.tid] += 1
        return snap

    def join(self, token: dict):
        """Merge a fork token into the calling thread's clock."""
        st = self._state()
        clock = st.clock
        for t, c in token.items():
            if clock.get(t, 0) < c:
                clock[t] = c
        clock[st.tid] += 1

    # ---- the access check -------------------------------------------------
    def _access(self, shared: "Shared", is_write: bool):
        st = self._state()
        self.accesses += 1
        tid, clock = st.tid, st.clock
        lockset = frozenset(st.held)
        with self._mu:
            entry = shared._race
            if entry is None or entry[0] is not self:
                var = _VarState()
                shared._race = (self, var)
            else:
                var = entry[1]
            w = var.write
            if w is not None and w[0] != tid and clock.get(w[0], 0) < w[1] \
                    and not (w[2] & lockset):
                self._report(shared, w, is_write, "write")
            if is_write:
                for rt, r in var.reads.items():
                    if rt != tid and clock.get(rt, 0) < r[0] \
                            and not (r[1] & lockset):
                        self._report(shared, (rt,) + r, True, "read")
                var.write = (tid, clock[tid], lockset, _site())
                var.reads.clear()
            else:
                var.reads[tid] = (clock[tid], lockset, _site())

    def _report(self, shared: "Shared", prior, cur_is_write: bool,
                prior_kind: str):
        # self._mu held
        site = _site()
        prior_site = prior[3] if len(prior) > 3 else prior[2]
        key = (shared.name, prior_site, site)
        if key in self._reported or \
                len(self.violations) >= self.max_violations:
            return
        self._reported.add(key)
        cur_kind = "write" if cur_is_write else "read"
        v = RaceViolation(
            kind="data-race", variable=shared.name,
            first_site=prior_site, second_site=site,
            message=(f"data race on {shared.name!r}: {prior_kind} at "
                     f"{prior_site} races {cur_kind} at {site} "
                     "(disjoint locksets, unordered vector clocks)"))
        self.violations.append(v)

    def report(self) -> str:
        with self._mu:
            vs = list(self.violations)
        if not vs:
            return "racedep: no violations"
        return "racedep: %d violation(s)\n" % len(vs) + \
            "\n".join(f"  {v}" for v in vs)


# --------------------------------------------------------------------------
# module-level arming API (mirrors lockdep)
# --------------------------------------------------------------------------
def arm(**kw) -> RaceDep:
    """Install a fresh global detector; returns it. Nesting is rejected —
    use :func:`capture` to scope a detector inside an armed region."""
    global _DETECTOR
    if _DETECTOR is not None:
        raise RuntimeError("racedep already armed — use capture() to nest")
    _DETECTOR = RaceDep(**kw)
    _lockdep._RACE = _DETECTOR
    return _DETECTOR


def disarm() -> list[RaceViolation]:
    """Remove the global detector; returns its recorded violations."""
    global _DETECTOR
    det, _DETECTOR = _DETECTOR, None
    _lockdep._RACE = None
    return det.violations if det is not None else []


class capture:
    """``with capture() as det:`` — scope a detector, restoring whatever
    was armed before. Self-tests plant deliberate races inside one so the
    suite-wide detector never sees them."""

    def __init__(self, **kw):
        self._kw = kw
        self.detector: RaceDep | None = None

    def __enter__(self) -> RaceDep:
        global _DETECTOR
        self._prev = _DETECTOR
        self.detector = _DETECTOR = RaceDep(**self._kw)
        _lockdep._RACE = self.detector
        return self.detector

    def __exit__(self, *exc):
        global _DETECTOR
        _DETECTOR = self._prev
        _lockdep._RACE = self._prev
        return False


def current() -> RaceDep | None:
    return _DETECTOR


def fork_point() -> dict | None:
    """Clock snapshot for work handed to another thread (scheduler submit,
    thread spawn). Returns ``None`` disarmed — pass it to
    :func:`join_point` unconditionally."""
    det = _DETECTOR
    return det.fork() if det is not None else None


def join_point(token: dict | None):
    """Join a :func:`fork_point` token on the thread that runs the work."""
    det = _DETECTOR
    if det is not None and token is not None:
        det.join(token)


# --------------------------------------------------------------------------
# sanctioned thread spawn (the bare-thread lint rule's escape hatch)
# --------------------------------------------------------------------------
class TrackedThread(threading.Thread):
    """``threading.Thread`` with fork/join happens-before edges: the child
    starts with the spawner's clock, and ``join()`` merges the child's
    final clock back into the joiner."""

    def __init__(self, target: Callable, args=(), kwargs=None, *,
                 name=None, daemon=None):
        super().__init__(name=name, daemon=daemon)
        self._rd_target = target
        self._rd_args = args
        self._rd_kwargs = kwargs or {}
        self._rd_token = fork_point()
        self._rd_final: dict | None = None

    def run(self):
        join_point(self._rd_token)
        try:
            self._rd_target(*self._rd_args, **self._rd_kwargs)
        finally:
            self._rd_final = fork_point()

    def join(self, timeout=None):
        super().join(timeout)
        if not self.is_alive():
            join_point(self._rd_final)


def spawn(target: Callable, *args, name: str | None = None,
          daemon: bool = True, start: bool = True, **kwargs) -> TrackedThread:
    """Start (or with ``start=False``, just build) a :class:`TrackedThread`.

    The tree's only sanctioned way to create a thread outside
    ``analysis/`` and ``core/clock.py`` — the ``bare-thread`` lint rule
    rejects raw ``threading.Thread(...)`` so racedep/lockdep always see
    thread identity and the fork/join edges."""
    t = TrackedThread(target, args, kwargs, name=name, daemon=daemon)
    if start:
        t.start()
    return t


# --------------------------------------------------------------------------
# the instrumentation layer
# --------------------------------------------------------------------------
#: methods that mutate their receiver — recorded as writes; every other
#: proxied method (get/keys/values/items/count/index/copy/…) is a read
_WRITE_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "remove",
    "discard", "clear", "rotate", "move_to_end", "sort", "reverse",
})


class Shared:
    """Recording proxy around one shared mutable structure.

    Supports the dict/list/deque/set surface the spine uses: dunder access
    (``len``/``iter``/``in``/``[]``/``==``/``bool``) plus named methods,
    classified read-or-write by :data:`_WRITE_METHODS`. Unknown attributes
    delegate unrecorded (e.g. ``maxlen``). The wrapped object is reachable
    as ``_obj`` for code that must bypass recording (none in-tree).
    """

    __slots__ = ("_obj", "name", "_race", "__dict__", "__weakref__")

    def __init__(self, obj, name: str = "shared"):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_race", None)

    # ---- dunder reads ----------------------------------------------------
    def __len__(self):
        det = _DETECTOR
        if det is not None:
            det._access(self, False)
        return len(self._obj)

    def __bool__(self):
        det = _DETECTOR
        if det is not None:
            det._access(self, False)
        return bool(self._obj)

    def __iter__(self):
        det = _DETECTOR
        if det is not None:
            det._access(self, False)
        return iter(self._obj)

    def __contains__(self, item):
        det = _DETECTOR
        if det is not None:
            det._access(self, False)
        return item in self._obj

    def __getitem__(self, key):
        det = _DETECTOR
        if det is not None:
            det._access(self, False)
        return self._obj[key]

    def __eq__(self, other):
        det = _DETECTOR
        if det is not None:
            det._access(self, False)
        if isinstance(other, Shared):
            other = other._obj
        return self._obj == other

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self._obj)  # raises for mutables, same as unwrapped

    def __repr__(self):
        return f"Shared({self.name!r}, {self._obj!r})"

    # ---- dunder writes ---------------------------------------------------
    def __setitem__(self, key, value):
        det = _DETECTOR
        if det is not None:
            det._access(self, True)
        self._obj[key] = value

    def __delitem__(self, key):
        det = _DETECTOR
        if det is not None:
            det._access(self, True)
        del self._obj[key]

    # ---- named methods ---------------------------------------------------
    def __getattr__(self, attr):
        # only reached on the FIRST lookup of each method per instance: the
        # recording wrapper is cached in the instance __dict__, so every
        # later lookup is a plain attribute hit and a call costs one
        # module-global read (the disarmed-overhead budget depends on this)
        bound = getattr(object.__getattribute__(self, "_obj"), attr)
        if not callable(bound):
            return bound
        is_write = attr in _WRITE_METHODS

        def recording(*a, **kw):
            det = _DETECTOR
            if det is not None:
                det._access(self, is_write)
            return bound(*a, **kw)

        recording.__name__ = attr
        self.__dict__[attr] = recording
        return recording


def tracked_state(*names: str):
    """Class decorator: every assignment to a listed attribute wraps the
    value in a :class:`Shared` proxy named ``Class.attr`` — covering both
    ``__init__`` and later whole-structure rebindings. With instrumentation
    disabled (:func:`set_instrumentation`), assignments pass through raw
    (the overhead benchmark's uninstrumented baseline).
    """
    tracked = frozenset(names)

    def deco(cls):
        prev_setattr = cls.__setattr__
        label = cls.__name__

        def __setattr__(self, name, value):
            if name in tracked and _INSTRUMENT \
                    and not isinstance(value, Shared):
                value = Shared(value, f"{label}.{name}")
            prev_setattr(self, name, value)

        cls.__setattr__ = __setattr__
        existing = getattr(cls, "_tracked_state", frozenset())
        cls._tracked_state = frozenset(existing | tracked)
        return cls

    return deco
