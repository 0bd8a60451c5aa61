"""Cloud-Run-style autoscaler behaviour: cold starts, 0→N→0, fault injection."""
from repro_torch.core import AutoscalingService, Metrics, SimScheduler
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


def make(n_requests=10, service_time=30.0, **kw):
    sched = SimScheduler()
    svc = AutoscalingService("conv", sched, lambda req: service_time, **kw)
    done = []
    for i in range(n_requests):
        svc.receive({"i": i}, lambda ok, i=i: done.append((i, ok)))
    return sched, svc, done


def test_scale_up_to_demand_and_back_to_zero():
    sched, svc, done = make(n_requests=20, service_time=60.0,
                            max_instances=10, cold_start=10.0,
                            scale_down_delay=30.0)
    sched.run(until=50.0)
    assert svc.instance_count() == 10  # burst scaled to the cap
    sched.run()
    assert len(done) == 20 and all(ok for _, ok in done)
    assert svc.instance_count() == 0  # scaled back to zero
    assert svc.cold_starts == 10


def test_cold_start_delays_first_completion():
    sched, svc, done = make(n_requests=1, service_time=60.0, cold_start=25.0)
    sched.run(until=84.0)
    assert not done  # 25 cold + 60 service > 84
    sched.run(until=86.0)
    assert len(done) == 1


def test_min_instances_serve_warm():
    sched = SimScheduler()
    svc = AutoscalingService("conv", sched, lambda r: 60.0,
                             min_instances=2, cold_start=25.0,
                             scale_down_delay=30.0)
    done = []
    svc.receive({"i": 0}, lambda ok: done.append(ok))
    sched.run(until=61.0)
    assert done  # no cold start paid
    assert svc.cold_starts == 0
    sched.run(until=500.0)
    assert svc.instance_count() == 2  # floor respected


def test_concurrency_packs_requests():
    sched = SimScheduler()
    svc = AutoscalingService("conv", sched, lambda r: 50.0,
                             concurrency=4, max_instances=2, cold_start=0.0)
    done = []
    for i in range(8):
        svc.receive({"i": i}, lambda ok: done.append(ok))
    sched.run(until=10.0)
    assert svc.instance_count() <= 2
    sched.run()
    assert len(done) == 8


def test_killed_instance_loses_work_but_counts_no_completion():
    sched = SimScheduler()
    svc = AutoscalingService("conv", sched, lambda r: 100.0, cold_start=0.0)
    done = []
    svc.receive({"i": 0}, lambda ok: done.append(ok))
    sched.run(until=10.0)
    killed = svc.kill_instance()
    assert killed is not None
    sched.run()
    assert not done  # the in-flight request produced no completion (no ack)


def test_instance_timeseries_ramps_and_decays():
    sched, svc, done = make(n_requests=50, service_time=90.0,
                            max_instances=100, cold_start=10.0,
                            scale_down_delay=60.0)
    sched.run()
    series = svc.metrics.timeseries("svc.conv.instances")
    counts = [v for _, v in series]
    assert max(counts) == 50  # Figure 3's plateau
    assert counts[-1] == 0  # and decay to zero
