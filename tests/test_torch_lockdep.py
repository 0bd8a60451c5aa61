"""Lockdep self-tests: every detector fires on a planted violation, and the
legitimate concurrency patterns in the tree (consistent lock orders,
re-entrancy, condition waits, the fleet's budget-exempt shed/nack path) stay
violation-free.

Planted violations run inside ``lockdep.capture()`` so the suite-wide
detector armed by the port fixtures (tests/_torch_spine.py) never sees them."""
import random
import threading

import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.analysis import lockdep, racedep
from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.core import ConversionPipeline, SimScheduler
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


def _kinds(det):
    return [v.kind for v in det.violations]


# ------------------------------------------------------- seeded violations
def test_inversion_detected_same_thread():
    a, b = TrackedLock("A"), TrackedLock("B")
    with lockdep.capture() as det:
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    assert "inversion" in _kinds(det)
    msg = next(v for v in det.violations if v.kind == "inversion").message
    assert "A" in msg and "B" in msg


def test_inversion_detected_across_threads():
    # thread 1 takes A→B, thread 2 takes B→A — the classic ABBA deadlock
    # candidate, sequenced with events so the run itself never deadlocks
    a, b = TrackedLock("A"), TrackedLock("B")
    first_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        first_done.set()

    def t2():
        first_done.wait(5.0)
        with b:
            with a:
                pass

    with lockdep.capture() as det:
        threads = [racedep.spawn(t1, start=False),
                   racedep.spawn(t2, start=False)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
    assert _kinds(det).count("inversion") == 1


def test_three_lock_cycle_detected():
    a, b, c = TrackedLock("A"), TrackedLock("B"), TrackedLock("C")
    with lockdep.capture() as det:
        with a, b:     # A→B
            pass
        with b, c:     # B→C
            pass
        with c, a:     # C→A closes the 3-cycle
            pass
    assert "inversion" in _kinds(det)


def test_callback_under_lock_detected():
    lk = TrackedLock("guard")
    with lockdep.capture() as det:
        with lk:
            lockdep.check_callback("planted.endpoint")
    vs = [v for v in det.violations if v.kind == "callback-under-lock"]
    assert len(vs) == 1
    assert "planted.endpoint" in vs[0].message
    assert "guard" in vs[0].message


def test_held_too_long_detected():
    lk = TrackedLock("slow")
    with lockdep.capture(max_hold=0.0) as det:
        with lk:
            sum(range(1000))  # any nonzero hold beats max_hold=0
    assert "held-too-long" in _kinds(det)


def _with_block(lk, x):
    with lk:
        y = x + 1
    return y * 2


def _acquire_release(lk, x):
    lk.acquire()
    y = x + 1
    lk.release()
    return y * 2


@pytest.mark.parametrize("body", [_with_block, _acquire_release],
                         ids=["with", "acquire"])
def test_acquired_in_compile_detected(body):
    """The port's counterpart of the reference's jit case: a lock taken
    inside a ``torch.compile``d function is reported, whether Dynamo runs
    the lock eagerly on its behalf or traces it."""
    lk = TrackedLock("compile-victim")
    f = torch.compile(lambda x: body(lk, x), backend="eager")
    with lockdep.capture() as det:
        assert f(torch.ones(3)).tolist() == [4.0, 4.0, 4.0]
    assert "acquired-in-jit" in _kinds(det)
    assert not lk.locked()
    # the same function called eagerly takes the lock cleanly
    with lockdep.capture() as det:
        body(lk, torch.ones(3))
    assert det.violations == []


@pytest.mark.gpu
def test_acquired_in_cuda_graph_capture_detected():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lk = TrackedLock("capture-victim")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with lockdep.capture() as det:
        with torch.cuda.graph(g):
            with lk:  # held on the host at capture; a replay never takes it
                y = x * 2
    g.replay()
    torch.cuda.synchronize()
    assert y.sum().item() == 2048
    assert "acquired-in-jit" in _kinds(det)


def test_arm_rejects_nesting():
    # the port fixture already armed the global detector for this test
    assert lockdep.current() is not None
    with pytest.raises(RuntimeError):
        lockdep.arm()


# --------------------------------------------------------- negative space
def test_consistent_order_across_threads_is_clean():
    a, b = TrackedLock("A"), TrackedLock("B")

    def worker():
        for _ in range(50):
            with a:
                with b:
                    pass

    with lockdep.capture() as det:
        threads = [racedep.spawn(worker, start=False) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
    assert det.violations == []
    assert det.edges_recorded == 1  # A→B once, deduplicated


def test_disjoint_orders_in_different_threads_are_clean():
    # t1 uses A→B, t2 uses C→D: no shared locks, no cycle, no violation
    a, b = TrackedLock("A"), TrackedLock("B")
    c, d = TrackedLock("C"), TrackedLock("D")

    def t1():
        with a, b:
            pass

    def t2():
        with c, d:
            pass

    with lockdep.capture() as det:
        threads = [racedep.spawn(t1, start=False),
                   racedep.spawn(t2, start=False)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
    assert det.violations == []


def test_sequential_same_class_locks_never_alias():
    # N shard locks sharing a name, taken one at a time (the
    # ShardedDicomStore pattern): per-instance nodes, zero edges
    shards = [TrackedLock("Shard._lock") for _ in range(8)]
    with lockdep.capture() as det:
        for lk in shards:
            with lk:
                pass
    assert det.violations == []
    assert det.edges_recorded == 0


def test_reentrant_reacquisition_is_clean():
    lk = TrackedLock("R", reentrant=True)
    with lockdep.capture() as det:
        with lk:
            with lk:
                with lk:
                    pass
        assert det.held_locks() == []
    assert det.violations == []
    assert det.edges_recorded == 0  # re-entry records no self-edge


def test_condition_wait_is_clean():
    # Condition(TrackedLock): wait() fully releases (held-time stops) and
    # re-acquires (bookkeeping resumes); a slow consumer under a tiny
    # max_hold must not trip held-too-long while parked in wait()
    lk = TrackedLock("cond-lock", reentrant=True)
    cond = threading.Condition(lk)
    ready = []

    def producer():
        with cond:
            ready.append(True)
            cond.notify_all()

    with lockdep.capture(max_hold=0.5) as det:
        with cond:
            t = racedep.spawn(producer, start=False)
            t.start()
            while not ready:
                cond.wait(timeout=5.0)
            t.join(5.0)
        assert det.held_locks() == []
    assert det.violations == []


def test_check_callback_with_nothing_held_is_clean():
    with lockdep.capture() as det:
        lockdep.check_callback("free.endpoint")
    assert det.violations == []


def test_locked_probe():
    lk = TrackedLock("probe")
    rlk = TrackedLock("rprobe", reentrant=True)
    for target in (lk, rlk):
        assert not target.locked()
        with target:
            assert target.locked()
        assert not target.locked()


# ------------------------------------- fleet shed/nack path (satellite 3)
def _run_shed_heavy_trace(seed: int):
    """Burst arrivals into a tiny fleet with an aggressive shed threshold:
    most deliveries take the budget-exempt ``nack(consume_budget=False)``
    requeue path before eventually completing."""
    rng = random.Random(seed)
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=30.0, cold_start=5.0, max_instances=2,
        min_backoff=5.0, max_backoff=40.0, ack_deadline=120.0,
        subscribers=False, fleet=dict(shed_backlog=2), ordered_ingest=True)
    n = rng.randint(6, 16)
    keys = [f"ok/s{i:03d}.psv" for i in range(n)]
    for i, key in enumerate(keys):
        # near-simultaneous burst → backlog spikes past shed_backlog
        sched.schedule(rng.uniform(0.0, 2.0), pipe.ingest, key,
                       bytes([i % 251]) * (i + 1), {"slide_id": key})
    sched.run()
    return pipe, keys


def _assert_shed_trace_clean(pipe, keys):
    det = lockdep.current()
    assert det is not None, "suite-wide lockdep must be armed"
    assert det.violations == [], det.report()
    # the scenario actually exercised the shed path, and still settled
    assert pipe.metrics.get("svc.wsi2dcm.shed") > 0
    assert pipe.subscription.stats()["acked"] == len(keys)
    assert pipe.subscription.stats()["outstanding"] == 0
    assert pipe.dead_lettered == []


def test_fleet_shed_nack_path_lockdep_clean_seeded_sweep():
    for seed in range(5):
        pipe, keys = _run_shed_heavy_trace(seed)
        _assert_shed_trace_clean(pipe, keys)


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_fleet_shed_nack_path_lockdep_clean_property(seed):
    pipe, keys = _run_shed_heavy_trace(seed)
    _assert_shed_trace_clean(pipe, keys)
