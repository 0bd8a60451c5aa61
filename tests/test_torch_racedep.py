"""Racedep self-tests: the detector fires on planted data races — including
test doubles of the three historical interleaving bugs PRs 2/4 fixed by
hand — and stays silent on every synchronized pattern the tree uses
(lock-guarded access, condition handoff, scheduler fork/join, tracked
spawns).

Planted races run inside ``racedep.capture()`` so the suite-wide detector
armed by the port fixtures (tests/_torch_spine.py) never sees them. Note the vector-clock property that
makes these tests deterministic: two spawned threads are unordered by
happens-before even if the OS happens to run them back-to-back, so a
planted race is reported on every run, not just unlucky ones.
"""
import pytest

from repro_torch.analysis import racedep
from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.analysis.racedep import Shared, tracked_state
from repro_torch.core import RealScheduler, SimScheduler
from repro_torch.core.metrics import Metrics
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


def _race_vars(det):
    return [v.variable for v in det.violations]


def _spawn_join(*fns):
    threads = [racedep.spawn(fn, start=False) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)


# ------------------------------------------------------------ planted races
def test_unsynchronized_writes_race():
    with racedep.capture() as det:
        d = Shared({}, "t.d")

        def w1():
            d["k"] = 1

        def w2():
            d["k"] = 2

        _spawn_join(w1, w2)
    assert "t.d" in _race_vars(det)
    v = det.violations[0]
    assert "t.d" in v.message and v.first_site != "<unknown>"
    assert v.first_site != v.second_site


def test_read_write_race_reports_both_sites():
    with racedep.capture() as det:
        items = Shared([], "t.items")

        def reader():
            len(items)

        def writer():
            items.append(1)

        _spawn_join(reader, writer)
    assert _race_vars(det) == ["t.items"]
    v = det.violations[0]
    assert "test_torch_racedep.py" in v.first_site
    assert "test_torch_racedep.py" in v.second_site


def test_disjoint_locksets_still_race():
    """Each thread holds *a* lock — just not the same one (the classic
    Eraser case a pure happens-before detector can miss and a pure
    lockset detector exists to catch)."""
    la, lb = TrackedLock("ra"), TrackedLock("rb")
    with racedep.capture() as det:
        d = Shared({}, "t.split")

        def w1():
            with la:
                d["k"] = 1

        def w2():
            with lb:
                d["k"] = 2

        _spawn_join(w1, w2)
    assert "t.split" in _race_vars(det)


def test_duplicate_race_reported_once():
    with racedep.capture() as det:
        d = Shared({}, "t.dup")

        def w1():
            for _ in range(50):
                d["k"] = 1

        def w2():
            for _ in range(50):
                d["k"] = 2

        _spawn_join(w1, w2)
    # many colliding accesses from one site pair: one report
    assert len([v for v in det.violations if v.variable == "t.dup"]) <= 2


# ------------------------------------------- historical bugs as test doubles
def test_double_hedge_settlement_detected():
    """PR 4's bug: the original delivery and its hedge both completed, and
    both settled — the check and the claim were not atomic. The double
    re-plants that access pattern: two completion paths read ``done`` then
    write it without the subscription lock's claim."""
    with racedep.capture() as det:
        outstanding = Shared({7: "ctx"}, "double.outstanding")
        converted = Shared([], "double.converted")

        def settle():
            # the pre-fix shape of Subscription._settle: check-then-act
            # with no lock — both the original and the hedge pass the
            # check and both convert
            if 7 in outstanding:
                converted.append("slide-7")

        _spawn_join(settle, settle)
    assert "double.converted" in _race_vars(det) or \
        "double.outstanding" in _race_vars(det)


def test_callback_order_race_detected():
    """PR 2's bug: the pump invoked the endpoint callback while another
    thread was still mutating the subscription's backlog — the callback
    observed (and mutated) the deque mid-update. The double re-plants the
    unguarded backlog handoff between pump and callback."""
    with racedep.capture() as det:
        backlog = Shared([], "double.backlog")

        def pump():
            backlog.append("msg-1")  # enqueue outside the lock

        def callback():
            if backlog:              # endpoint draining concurrently
                backlog.pop()

        _spawn_join(pump, callback)
    assert "double.backlog" in _race_vars(det)


def test_unguarded_metrics_inc_detected():
    """The Metrics variant PR 8's audit killed: ``counters[name] += v``
    without the lock loses increments when pool threads collide. The
    double bypasses ``Metrics.inc`` and hits the (tracked) dict raw."""
    with racedep.capture() as det:
        m = Metrics()

        def bump():
            # read-modify-write with no lock — the exact pre-audit shape
            m.counters["svc.conv.requests"] = \
                m.counters["svc.conv.requests"] + 1

        _spawn_join(bump, bump)
    assert "Metrics.counters" in _race_vars(det)


def test_guarded_metrics_inc_is_clean():
    """...and the shipped, locked ``inc`` on the same structure is clean."""
    with racedep.capture() as det:
        m = Metrics()
        _spawn_join(*[lambda: m.inc("svc.conv.requests")] * 4)
    assert det.violations == []
    assert m.get("svc.conv.requests") == 4.0


# ------------------------------------------------- synchronized negative space
def test_same_lock_orders_accesses():
    lk = TrackedLock("t.guard")
    with racedep.capture() as det:
        d = Shared({}, "t.guarded")

        def w(v):
            def go():
                with lk:
                    d["k"] = v
            return go

        _spawn_join(w(1), w(2))
    assert det.violations == []


def test_spawn_join_edge_orders_accesses():
    with racedep.capture() as det:
        d = Shared({}, "t.forkjoin")
        d["k"] = "parent"          # before fork: ordered by the spawn token

        def child():
            d["k"] = "child"

        t = racedep.spawn(child)
        t.join(10.0)
        assert d["k"] == "child"   # after join: ordered by the join edge
    assert det.violations == []


def test_sequential_spawns_are_ordered_through_parent():
    """T1 completes and is joined before T2 spawns: T2 inherits T1's
    history through the parent's clock — no race despite no common lock."""
    with racedep.capture() as det:
        d = Shared({}, "t.seq")

        def w1():
            d["a"] = 1

        def w2():
            d["a"] = 2

        t1 = racedep.spawn(w1)
        t1.join(10.0)
        t2 = racedep.spawn(w2)
        t2.join(10.0)
    assert det.violations == []


def test_lock_handoff_orders_across_threads():
    """A writes under L, B later takes L and writes: the release→acquire
    edge orders them even though the accesses themselves were seconds
    apart in different threads."""
    lk = TrackedLock("t.handoff")
    with racedep.capture() as det:
        d = Shared({}, "t.handoff_var")

        def first():
            with lk:
                d["k"] = 1

        t1 = racedep.spawn(first)
        t1.join(10.0)

        def second():
            with lk:
                assert d["k"] == 1
                d["k"] = 2

        t2 = racedep.spawn(second)
        t2.join(10.0)
    assert det.violations == []


def test_realscheduler_submit_edge_orders_accesses():
    """Main-thread state written before schedule() is visible to the pool
    thread, and main's post-run() read is ordered after the worker's
    write — the fork/join token plus the quiescence condition wait."""
    sched = RealScheduler(workers=2)
    try:
        with racedep.capture() as det:
            d = Shared({}, "t.sched")
            d["k"] = "main"

            def work():
                assert d["k"] == "main"
                d["k"] = "worker"

            sched.schedule(0.0, work)
            sched.run(until=10.0)
            assert d["k"] == "worker"
        assert det.violations == []
    finally:
        sched.shutdown()


def test_condition_wait_covered_by_lock_edges():
    """The producer/consumer condition handoff (RealScheduler.run's own
    pattern) generates no reports: wait's release/re-acquire go through
    TrackedLock's _release_save/_acquire_restore."""
    import threading

    lk = TrackedLock("t.cond")
    cond = threading.Condition(lk)
    with racedep.capture() as det:
        box = Shared([], "t.box")

        def producer():
            with cond:
                box.append("ready")
                cond.notify_all()

        t = racedep.spawn(producer, start=False)
        with cond:
            t.start()
            while not box:
                cond.wait(timeout=5.0)
            assert box[0] == "ready"
        t.join(5.0)
    assert det.violations == []


def test_single_thread_never_races():
    with racedep.capture() as det:
        d = Shared({}, "t.solo")
        for i in range(100):
            d[i] = i
            _ = d[i]
        assert len(d) == 100
    assert det.violations == []


def test_sim_scheduler_is_single_threaded_and_clean():
    sched = SimScheduler()
    with racedep.capture() as det:
        d = Shared({}, "t.sim")
        for i in range(20):
            sched.schedule(float(i % 3), d.__setitem__, i, i)
        sched.run()
        assert len(d) == 20
    assert det.violations == []


# -------------------------------------------------------- arming / instrument
def test_disarmed_records_nothing():
    prev = racedep._DETECTOR          # the port fixture armed the suite detector
    racedep._DETECTOR = None
    try:
        d = Shared({}, "t.off")
        d["k"] = 1
        assert d._race is None        # the disarmed fast path records nothing
    finally:
        racedep._DETECTOR = prev


def test_arm_rejects_nesting():
    # the port fixture already armed the suite detector
    with pytest.raises(RuntimeError, match="already armed"):
        racedep.arm()


def test_capture_scopes_and_restores():
    outer = racedep.current()
    with racedep.capture() as det:
        assert racedep.current() is det
        d = Shared({}, "t.scoped")

        def w1():
            d["k"] = 1

        def w2():
            d["k"] = 2

        _spawn_join(w1, w2)
    assert racedep.current() is outer
    assert det.violations  # stayed in the scoped detector
    assert all(v.variable != "t.scoped"
               for v in (outer.violations if outer else []))


def test_max_violations_bounds_reports():
    with racedep.capture(max_violations=1) as det:
        shared = [Shared({}, f"t.cap{i}") for i in range(5)]

        def w(v):
            def go():
                for s in shared:
                    s["k"] = v
            return go

        _spawn_join(w(1), w(2))
    assert len(det.violations) == 1


def test_instrumentation_kill_switch():
    """set_instrumentation(False): structures built while disabled carry
    raw containers (the overhead benchmark's uninstrumented baseline)."""
    prev = racedep.set_instrumentation(False)
    try:
        m = Metrics()
        assert not isinstance(m.counters, Shared)
    finally:
        racedep.set_instrumentation(prev)
    m2 = Metrics()
    assert isinstance(m2.counters, Shared)


# ------------------------------------------------------------- tracked_state
def test_tracked_state_wraps_init_and_rebinding():
    @tracked_state("items")
    class Box:
        def __init__(self):
            self.items = []
            self.plain = 0

    b = Box()
    assert isinstance(b.items, Shared)
    assert b.items.name == "Box.items"
    assert not isinstance(b.plain, Shared)
    b.items = ["rebound"]          # rebuild_index-style whole swap
    assert isinstance(b.items, Shared)
    assert list(b.items) == ["rebound"]


def test_shared_delegates_container_surface():
    d = Shared({"a": 1}, "t.surface")
    assert d == {"a": 1} and not d != {"a": 1}
    assert "a" in d and len(d) == 1 and list(d) == ["a"]
    assert d["a"] == 1 and d.get("b", 9) == 9
    assert dict(d) == {"a": 1}
    d["b"] = 2
    del d["b"]
    assert d.setdefault("c", 3) == 3
    assert d.pop("c") == 3
    assert sorted(d.items()) == [("a", 1)]
    lst = Shared([3, 1], "t.list")
    lst.sort()
    assert lst == [1, 3] and repr(lst).startswith("Shared(")
    assert bool(Shared([], "t.empty")) is False


def test_shared_eq_between_proxies():
    assert Shared([1], "x") == Shared([1], "y")
