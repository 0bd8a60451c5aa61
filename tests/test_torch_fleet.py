"""Converter fleet: paper-claim assertions (Figures 2-3 through the
multi-instance fleet) plus fleet scheduling semantics — tenant fairness,
per-tenant quotas, backlog shedding, duplicate-delivery dedupe — and the
arrival-trace property (instance cap / quota cap / exactly-once-settled)
as both a Hypothesis property and an always-run seeded sweep.

The port's copy of ``tests/test_fleet.py``: the Figure 2/3 model is the
port's ``repro_torch.core.workflows``."""
import random

from _hypothesis_compat import given, settings, st

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from repro_torch.core import (ConversionPipeline, ConverterFleet, SimScheduler)
from repro_torch.core.workflows import (autoscaling_time, fig3_run,
                                        parallel_time, serial_time)

FLEET_KW = dict(fleet={}, ordered_ingest=True)
TAU = 90.0


# ---------------------------------------------------------------- paper claims
def test_fleet_loses_at_n1_under_cold_start():
    fleet_t = autoscaling_time(1, TAU, cold_start=12.0, **FLEET_KW)
    assert fleet_t > serial_time(1, TAU)


def test_fleet_beats_parallel_and_serial_at_scale():
    for n in (10, 50):
        fleet_t = autoscaling_time(n, TAU, cold_start=12.0, **FLEET_KW)
        assert fleet_t < parallel_time(n, TAU) < serial_time(n, TAU)


def test_fig3_fleet_ramps_to_plateau_and_decays():
    minutes, pipe = fig3_run(n=50, tau=TAU, cold_start=12.0,
                             max_instances=100, **FLEET_KW)
    peak = max(v for _, v in minutes)
    assert peak >= 45, f"should plateau near 50 instances, got {peak}"
    # the plateau never exceeds the configured ceiling, at ANY instant
    assert all(v <= 100 for _, v in pipe.instance_series())
    assert minutes[-1][1] == 0, "fleet should decay back to zero"
    assert pipe.done_count() == 50


# ------------------------------------------------------------ fleet scheduling
def _fleet(sched, handler, **kw):
    kw.setdefault("max_instances", 2)
    kw.setdefault("concurrency", 1)
    kw.setdefault("cold_start", 0.0)
    kw.setdefault("scale_down_delay", 5.0)
    return ConverterFleet("conv", sched, handler, **kw)


def test_tenant_fair_scheduling_interleaves_a_burst():
    sched = SimScheduler()
    order = []
    svc = _fleet(sched, lambda p: 10.0)
    done = []
    for i in range(8):
        svc.receive({"name": f"a{i}", "tenant": "lab-a"},
                    lambda ok, i=i: done.append(("lab-a", ok)),
                    key=("a", i))
    for i in range(2):
        svc.receive({"name": f"b{i}", "tenant": "lab-b"},
                    lambda ok, i=i: done.append(("lab-b", ok)),
                    key=("b", i))
    sched.run()
    assert len(done) == 10 and all(ok is True for _, ok in done)
    # round-robin dispatch: the small tenant's 2 jobs land inside the
    # first 4 completions instead of queueing behind lab-a's burst
    first4 = [t for t, _ in done[:4]]
    assert first4.count("lab-b") == 2, done


def test_tenant_quota_sheds_excess_and_caps_load_series():
    sched = SimScheduler()
    svc = _fleet(sched, lambda p: 10.0, tenant_quota=2, max_instances=4)
    verdicts = []
    for i in range(5):
        svc.receive({"name": f"a{i}"}, verdicts.append,
                    tenant="lab-a", key=("a", i))
    sched.run()
    assert verdicts.count("shed") == 3
    assert verdicts.count(True) == 2
    load = svc.metrics.timeseries("svc.conv.tenant.lab-a.load")
    assert max(v for _, v in load) <= 2


def test_backlog_shedding_then_admission():
    sched = SimScheduler()
    svc = _fleet(sched, lambda p: 10.0, shed_backlog=2, max_instances=1,
                 instance_queue_depth=0)
    verdicts = []
    for i in range(5):
        svc.receive({"name": f"s{i}"}, verdicts.append, key=("s", i))
    assert verdicts.count("shed") == 3  # backlog capped at 2 waiting
    sched.run()
    # shed work re-offered later (the broker's budget-exempt requeue in the
    # full pipeline) is admitted once the backlog drains
    svc.receive({"name": "late"}, verdicts.append, key=("late",))
    sched.run()
    assert verdicts.count(True) == 3


def test_duplicate_delivery_dedupes_in_flight_and_completed():
    sched = SimScheduler()
    runs = []
    svc = _fleet(sched, lambda p: runs.append(p["name"]) or 10.0)
    done = []
    svc.receive({"name": "s"}, done.append, key=("s", "g1"))
    # duplicate while in flight: attaches, does not run the handler twice
    svc.receive({"name": "s"}, done.append, key=("s", "g1"))
    sched.run()
    assert runs == ["s"]
    assert done == [True, True]
    # duplicate after completion: settled immediately from the completed set
    svc.receive({"name": "s"}, done.append, key=("s", "g1"))
    assert done == [True, True, True]
    assert runs == ["s"]
    assert svc.metrics.get("svc.conv.duplicates") == 2


def test_kill_mid_conversion_requeues_victims_work_exactly_once():
    sched = SimScheduler()
    svc = _fleet(sched, lambda p: 50.0, max_instances=1,
                 instance_queue_depth=2)
    done = []
    for i in range(3):
        svc.receive({"name": f"s{i}"}, done.append, key=("s", i))
    # t=10: s0 mid-conversion, s1/s2 queued on the doomed instance
    sched.schedule(10.0, svc.kill_instance)
    sched.run()
    assert done == [True, True, True]
    assert svc.metrics.get("svc.conv.requeued") == 3
    assert svc.metrics.get("svc.conv.completed") == 3
    assert svc.instance_count() == 0  # scaled back down afterwards


def test_work_stealing_balances_late_capacity():
    # 1 instance is ready first and buffers the burst in its local queue;
    # when the controller's extra instances come up they steal it instead
    # of idling — completion is width-limited, not head-of-line-limited
    sched = SimScheduler()
    svc = _fleet(sched, lambda p: 30.0, max_instances=6, cold_start=1.0)
    done = []
    for i in range(6):
        svc.receive({"name": f"s{i}"}, done.append, key=("s", i))
    sched.run()
    assert done == [True] * 6
    lat = svc.metrics.timeseries("svc.conv.latency")
    assert max(v for _, v in lat) < 60.0, "a slide waited behind another"


# -------------------------------------------------- arrival-trace property
MAX_INSTANCES = 6
QUOTA = 4


def _run_trace(seed: int):
    """Random arrival trace through the full pipeline; returns invariants."""
    rng = random.Random(seed)
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=lambda ev: _service(ev), cold_start=5.0,
        max_instances=MAX_INSTANCES, min_backoff=5.0, max_backoff=40.0,
        ack_deadline=120.0, subscribers=False,
        fleet=dict(tenant_quota=QUOTA, shed_backlog=12), ordered_ingest=True)

    def _service(event):
        if event["name"].startswith("bad/"):
            raise RuntimeError("poison slide")
        return 20.0 + (event["generation"] and 0.0)

    n = rng.randint(4, 24)
    good, poison = [], []
    for i in range(n):
        bad = rng.random() < 0.2
        key = f"{'bad' if bad else 'ok'}/s{i:03d}.psv"
        (poison if bad else good).append(key)
        tenant = rng.choice(["lab-a", "lab-b", "lab-c"])
        delay = rng.uniform(0.0, 240.0)
        sched.schedule(delay, pipe.ingest, key, bytes([i % 251]) * (i + 1),
                       {"slide_id": key, "tenant": tenant})
    sched.run()
    return pipe, good, poison


def _assert_trace_invariants(pipe, good, poison):
    # 1) the instance cap holds at every step of the run
    series = pipe.instance_series()
    assert all(v <= MAX_INSTANCES for _, v in series), max(
        v for _, v in series)
    # 2) per-tenant admitted load never exceeds the quota
    for tenant in ("lab-a", "lab-b", "lab-c"):
        load = pipe.metrics.timeseries(f"svc.wsi2dcm.tenant.{tenant}.load")
        assert all(v <= QUOTA for _, v in load)
    # 3) every slide settles exactly once: good → acked conversion,
    #    poison → dead-lettered (and never both)
    dead = [ev["name"] for ev, _ in pipe.dead_lettered]
    assert sorted(dead) == sorted(poison)
    # acked == one settled delivery per good slide (the completed metric
    # also counts a poison slide's failed attempts, so it is no measure
    # of success); nothing left in flight
    assert pipe.subscription.stats()["acked"] == len(good)
    assert pipe.subscription.stats()["backlog"] == 0
    assert pipe.subscription.stats()["outstanding"] == 0


def test_random_arrival_traces_seeded_sweep():
    for seed in range(8):
        pipe, good, poison = _run_trace(seed)
        _assert_trace_invariants(pipe, good, poison)


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_random_arrival_traces_property(seed):
    pipe, good, poison = _run_trace(seed)
    _assert_trace_invariants(pipe, good, poison)
