"""Runtime lockdep: instrumented locks + a lock-order race detector.

PRs 2, 4, and 7 each fixed real lock/ordering bugs by inspection
(ordering-key wedges, hedge settlement races, handlers invoked under a
lock). This module makes those invariants *checked* properties:

* :class:`TrackedLock` is a drop-in for ``threading.Lock`` /
  ``threading.RLock`` (``reentrant=True``) that also works as the lock of
  a ``threading.Condition`` (it implements the ``_release_save`` /
  ``_acquire_restore`` / ``_is_owned`` protocol, with the bookkeeping
  following the wait's release/re-acquire). With no detector armed, the
  per-operation overhead is one module-global read.
* :class:`LockDep` is the detector. While armed (:func:`arm` /
  :func:`capture`) it maintains, per thread, the stack of held tracked
  locks and a global directed acquisition graph ("A was held while B was
  acquired"). It reports:

  - **lock-order-inversion** — adding an edge A→B when B already reaches A
    closes a cycle: two threads can interleave into a deadlock even if
    this run did not. Reported with both acquisition sites.
  - **callback-under-lock** — infrastructure that invokes user callbacks
    (push endpoints, ``done`` completions, real-work handlers) calls
    :func:`check_callback` first; if the calling thread holds any tracked
    lock, that's the re-entrancy hazard PR 2 fixed by hand in
    ``AutoscalingService`` and ``Subscription._settle``.
  - **held-too-long** — a lock held longer than ``max_hold`` wall seconds
    (condition waits release the lock, so they never count).
  - **acquired-in-jit** — a lock acquired while ``torch.compile`` traces
    or a CUDA graph captures: the guard runs at trace or capture time only
    and silently protects nothing when the compiled code or the graph
    replays.

The detector's own mutable state is guarded by a *bare* ``threading.Lock``
on purpose — instrumenting the instrumentation would recurse. This module
is the single place the lint pass allows one.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
import traceback

__all__ = ["TrackedLock", "LockDep", "Violation", "arm", "disarm",
           "capture", "check_callback", "current"]

#: the armed detector, or None. Read once per lock operation — keeping the
#: disarmed fast path to a single global load is what makes TrackedLock a
#: zero-cost default (see the overhead gate in benchmarks/fleet_bench.py).
_DETECTOR: "LockDep | None" = None

#: the armed race detector, or None — set by :mod:`repro_torch.analysis.racedep`
#: (arm/disarm/capture) so TrackedLock emits happens-before edges without
#: this module importing racedep (imports flow racedep -> lockdep only)
_RACE = None


def _site(skip: int = 2) -> str:
    """Caller's source site, a few frames up, for violation reports."""
    frames = traceback.extract_stack(limit=skip + 6)[:-skip]
    own = __file__.rstrip("co")  # .pyc -> .py
    frames = [f for f in frames if not f.filename.startswith(own)]
    if not frames:
        return "<unknown>"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} in {f.name}"


_DYNAMO_CALLBACK = None  # torch._C._dynamo.eval_frame.get_eval_frame_callback


def _in_jit_trace() -> bool:
    """True while ``torch.compile`` is at work on the calling thread, or
    while a CUDA graph captures on the current stream. Never imports torch.

    Dynamo runs the code it cannot trace (a raw lock's ``acquire`` is such
    code) eagerly, frame by frame, with its frame callback installed on the
    thread, so the callback marks a compiled region as well as
    ``torch.compiler.is_compiling()`` marks the trace itself. That flag is
    process-wide for a compile session: a lock taken on another thread
    while one compiles reads as taken inside it.
    """
    global _DYNAMO_CALLBACK
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    if torch.compiler.is_compiling():
        return True
    fn = _DYNAMO_CALLBACK
    if fn is None:
        dynamo = getattr(torch._C, "_dynamo", None)
        fn = _DYNAMO_CALLBACK = getattr(
            getattr(dynamo, "eval_frame", None), "get_eval_frame_callback",
            lambda: None)
    if callable(fn()):
        return True
    cuda = torch.cuda
    return cuda.is_initialized() and cuda.is_current_stream_capturing()


@dataclasses.dataclass
class Violation:
    kind: str      # inversion | callback-under-lock | held-too-long | ...
    message: str
    thread: str
    site: str

    def __str__(self):
        return f"[{self.kind}] {self.message} (thread {self.thread}, " \
               f"at {self.site})"


class TrackedLock:
    """Instrumented mutual exclusion — the project's only sanctioned lock.

    ``reentrant=False`` wraps ``threading.Lock``, ``reentrant=True`` wraps
    ``threading.RLock``. ``name`` labels the lock in reports; it defaults
    to the construction site (``module:line``), so per-instance locks of
    one class share a name but remain distinct graph nodes (cycles are
    detected per instance — N shard locks taken one at a time never
    alias).
    """

    __slots__ = ("_lock", "_reentrant", "name")

    def __init__(self, name: str | None = None, *, reentrant: bool = False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._reentrant = reentrant
        if name is None:
            f = sys._getframe(1)
            name = f"{f.f_globals.get('__name__', '?')}:{f.f_lineno}"
        self.name = name

    # ---- core lock protocol ----------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            det = _DETECTOR
            if det is not None:
                det._on_acquired(self)
            r = _RACE
            if r is not None:
                r._on_lock_acquired(self)
        return got

    def release(self):
        det = _DETECTOR
        if det is not None:
            det._on_released(self)
        r = _RACE
        if r is not None:
            r._on_lock_released(self)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        if self._reentrant:
            # RLock has no .locked() before 3.13. Owned by us → held; else
            # probe non-blocking (a probe from the owner would falsely
            # succeed, hence the ownership check first).
            if self._lock._is_owned():
                return True
            if self._lock.acquire(False):
                self._lock.release()
                return False
            return True
        return self._lock.locked()

    def __repr__(self):
        kind = "RLock" if self._reentrant else "Lock"
        return f"<TrackedLock({kind}) {self.name!r}>"

    # ---- threading.Condition protocol ------------------------------------
    # Condition(lock) wires wait() through these; the bookkeeping must
    # follow the wait's full release (held time stops) and re-acquisition
    # (a fresh acquisition: order edges are recorded again).
    def _release_save(self):
        det = _DETECTOR
        count = det._on_wait_release(self) if det is not None else None
        r = _RACE
        rcount = r._on_wait_release(self) if r is not None else None
        if self._reentrant:
            inner = self._lock._release_save()
        else:
            self._lock.release()
            inner = None
        return (inner, count, rcount)

    def _acquire_restore(self, state):
        inner, count, rcount = state
        if self._reentrant:
            self._lock._acquire_restore(inner)
        else:
            self._lock.acquire()
        det = _DETECTOR
        if det is not None:
            det._on_wait_acquire(self, count)
        r = _RACE
        if r is not None:
            r._on_wait_acquire(self, rcount)

    def _is_owned(self) -> bool:
        if self._reentrant:
            return self._lock._is_owned()
        # stdlib fallback semantics for non-reentrant locks: "owned" means
        # "held by someone" — a raw probe, no detector bookkeeping
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True


class LockDep:
    """The detector: per-thread held stacks + a global acquisition graph."""

    def __init__(self, *, max_hold: float | None = 30.0,
                 check_jit: bool = True):
        self.max_hold = max_hold
        self.check_jit = check_jit
        self.violations: list[Violation] = []
        self._tls = threading.local()
        # bare lock by design (see module docstring): the detector must
        # not instrument itself  # lint: allow(bare-lock)
        self._mu = threading.Lock()
        self._adj: dict[int, set[int]] = {}        # edge a -> {b}
        self._names: dict[int, str] = {}           # node id -> lock name
        self._edge_sites: dict[tuple[int, int], str] = {}
        self.edges_recorded = 0

    # ---- per-thread held stack -------------------------------------------
    def _held(self) -> list:
        try:
            return self._tls.held
        except AttributeError:
            h = self._tls.held = []  # entries: [lock, t_acquired, count]
            return h

    def held_locks(self) -> list[TrackedLock]:
        """Tracked locks the *calling thread* currently holds."""
        return [e[0] for e in self._held()]

    # ---- event hooks (called from TrackedLock) ---------------------------
    def _on_acquired(self, lock: TrackedLock):
        held = self._held()
        for e in held:
            if e[0] is lock:       # re-entrant re-acquisition: no new edge
                e[2] += 1
                return
        if self.check_jit and _in_jit_trace():
            self._violation(
                "acquired-in-jit",
                f"lock {lock.name!r} acquired inside a torch.compile region "
                "or a CUDA graph capture — the guard runs at trace time "
                "only and protects nothing when the compiled code replays")
        for e in held:
            self._add_edge(e[0], lock)
        # hold-time accounting wants real elapsed time even under
        # SimScheduler  # lint: allow(wall-clock)
        held.append([lock, time.monotonic(), 1])

    def _on_released(self, lock: TrackedLock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            e = held[i]
            if e[0] is lock:
                e[2] -= 1
                if e[2] == 0:
                    self._check_hold_time(lock, e[1])
                    del held[i]
                return
        # released a lock acquired before arming: nothing to unwind

    def _on_wait_release(self, lock: TrackedLock) -> int | None:
        """Condition.wait released the lock fully; returns the recursion
        count to restore (None if this detector never saw the acquire)."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            e = held[i]
            if e[0] is lock:
                self._check_hold_time(lock, e[1])
                count = e[2]
                del held[i]
                return count
        return None

    def _on_wait_acquire(self, lock: TrackedLock, count: int | None):
        if count is None:
            return  # armed mid-wait: we never saw the release
        held = self._held()
        for e in held:
            if e[0] is lock:
                e[2] += count
                return
        for e in held:
            self._add_edge(e[0], lock)
        held.append([lock, time.monotonic(), count])  # lint: allow(wall-clock)

    def _check_hold_time(self, lock: TrackedLock, t0: float):
        if self.max_hold is None:
            return
        dt = time.monotonic() - t0  # lint: allow(wall-clock)
        if dt > self.max_hold:
            self._violation(
                "held-too-long",
                f"lock {lock.name!r} held for {dt:.3f}s "
                f"(max_hold={self.max_hold}s)")

    # ---- the acquisition graph -------------------------------------------
    def _add_edge(self, a: TrackedLock, b: TrackedLock):
        ka, kb = id(a), id(b)
        with self._mu:
            succ = self._adj.setdefault(ka, set())
            if kb in succ:
                return
            self._names[ka] = a.name
            self._names[kb] = b.name
            site = _site()
            # closing edge a->b while b already reaches a = an inversion:
            # some other chain acquired these locks in the opposite order
            path = self._path(kb, ka)
            succ.add(kb)
            self._edge_sites[(ka, kb)] = site
            self.edges_recorded += 1
            if path is not None:
                names = [self._names[n] for n in [ka, kb] + path[1:]]
                sites = [site] + [
                    self._edge_sites.get((u, v), "?")
                    for u, v in zip([kb] + path[1:], path[1:])]
        if path is not None:
            self._violation(
                "inversion",
                "lock-order-inversion cycle: "
                + " -> ".join(names)
                + " | edge sites: " + " ; ".join(sites))

    def _path(self, src: int, dst: int) -> list[int] | None:
        """Node path src..dst in the edge graph (DFS), else None.
        Caller holds self._mu."""
        if src == dst:
            return [src]
        stack, parent = [src], {src: None}
        while stack:
            u = stack.pop()
            for v in self._adj.get(u, ()):
                if v in parent:
                    continue
                parent[v] = u
                if v == dst:
                    path, node = [], v
                    while node is not None:
                        path.append(node)
                        node = parent[node]
                    return path[::-1]
                stack.append(v)
        return None

    # ---- violations -------------------------------------------------------
    def _violation(self, kind: str, message: str):
        v = Violation(kind=kind, message=message,
                      thread=threading.current_thread().name, site=_site())
        with self._mu:
            self.violations.append(v)

    def report(self) -> str:
        with self._mu:
            vs = list(self.violations)
        if not vs:
            return "lockdep: no violations"
        return "lockdep: %d violation(s)\n" % len(vs) + \
            "\n".join(f"  {v}" for v in vs)


# --------------------------------------------------------------------------
# module-level arming API
# --------------------------------------------------------------------------
def arm(**kw) -> LockDep:
    """Install a fresh global detector; returns it. Nesting is not allowed
    (use :func:`capture` to scope a detector inside an armed region)."""
    global _DETECTOR
    if _DETECTOR is not None:
        raise RuntimeError("lockdep already armed — use capture() to nest")
    _DETECTOR = LockDep(**kw)
    return _DETECTOR


def disarm() -> list[Violation]:
    """Remove the global detector; returns its recorded violations."""
    global _DETECTOR
    det, _DETECTOR = _DETECTOR, None
    return det.violations if det is not None else []


class capture:
    """``with capture() as det:`` — scope a detector, restoring whatever
    was armed before. Self-tests plant deliberate violations inside one so
    the suite-wide detector never sees them."""

    def __init__(self, **kw):
        self._kw = kw
        self.detector: LockDep | None = None

    def __enter__(self) -> LockDep:
        global _DETECTOR
        self._prev = _DETECTOR
        self.detector = _DETECTOR = LockDep(**self._kw)
        return self.detector

    def __exit__(self, *exc):
        global _DETECTOR
        _DETECTOR = self._prev
        return False


def current() -> LockDep | None:
    return _DETECTOR


def check_callback(label: str):
    """Invariant check at every infrastructure→user-callback boundary:
    push endpoints, real-work handlers, and ``done`` completions must run
    with **no** tracked lock held (PR 2's hand-established rule, now
    machine-checked). Call right before invoking the callback."""
    det = _DETECTOR
    if det is None:
        return
    held = det.held_locks()
    if held:
        det._violation(
            "callback-under-lock",
            f"callback {label!r} invoked while holding "
            + ", ".join(repr(lk.name) for lk in held))
