"""Schedule-exploration self-tests: seeded tie-breaking is reproducible
and actually permutes, the explore harness proves the real-bytes fleet
scenario invariant-clean across many schedules, and a broken invariant
dumps a replayable seed+trace artifact.

The port's copy of ``tests/test_schedules.py``: the real-bytes exploration
runs ``REALBYTES_SEEDS`` seeds on the CPU (see there)."""
import json

import pytest

from repro_torch.analysis import racedep, schedules
from repro_torch.core import SimScheduler
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


# --------------------------------------------------------- seeded scheduler
def _run_order(seed, n=8):
    sched = SimScheduler(seed=seed, record_trace=True)
    out = []
    for i in range(n):
        sched.schedule(0.0, out.append, i)
    sched.run()
    return out, sched.trace


def test_same_seed_same_schedule():
    o1, t1 = _run_order(42)
    o2, t2 = _run_order(42)
    assert o1 == o2 and t1 == t2


def test_seed_none_keeps_legacy_fifo_order():
    out, trace = _run_order(None)
    assert out == list(range(8))
    assert [seq for seq, _, _ in trace] == list(range(8))


def test_seeds_permute_equal_timestamp_events():
    fifo = list(range(8))
    orders = {tuple(_run_order(s)[0]) for s in range(10)}
    assert len(orders) > 1, "ten seeds never permuted the schedule"
    assert any(o != tuple(fifo) for o in orders)


def test_timestamp_order_still_dominates_ties():
    """Seeding only permutes *equal-timestamp* events — virtual time
    ordering is untouched."""
    sched = SimScheduler(seed=99)
    out = []
    for i, delay in enumerate([3.0, 1.0, 2.0]):
        sched.schedule(delay, out.append, i)
    sched.run()
    assert out == [1, 2, 0]


def test_trace_records_fired_events_only():
    sched = SimScheduler(seed=1, record_trace=True)
    h = sched.schedule(0.0, lambda: None)
    sched.schedule(0.0, lambda: None)
    h.cancel()
    sched.run()
    assert len(sched.trace) == 1


def test_trace_off_by_default():
    sched = SimScheduler(seed=1)
    assert sched.trace is None


# ------------------------------------------------------------- the harness
def test_explore_sim_scenario_clean(tmp_path):
    report = schedules.explore(schedules.sim_fleet_scenario, seeds=3,
                               artifacts_dir=str(tmp_path))
    assert len(report.seeds) == 4  # FIFO + 3 seeded permutations
    assert report.accesses > 0
    assert not list(tmp_path.iterdir()), "clean run wrote artifacts"


#: seeded schedules of the real-bytes exploration on the CPU (the reference
#: explores 20): each schedule converts 4 slides twice and decodes 8
#: instances with the plain entropy decode, ~3 s a schedule at 32-px tiles
REALBYTES_SEEDS = 8


def test_explore_realbytes_fleet_8_seeds(tmp_path):
    """The acceptance tier on the port: the real-bytes fleet scenario —
    synthetic slides through the port's converter (CPU) under
    drop/duplicate/delay faults and an instance kill — settles every slide
    exactly once, emits study tars byte-identical to the serial baseline
    AND across schedules, and reports zero data races, for
    ``REALBYTES_SEEDS`` seeded schedules plus legacy FIFO. 32-px tiles
    keep the CPU decode of the inference hop short."""
    report = schedules.explore(
        schedules.realbytes_fleet_scenario, seeds=REALBYTES_SEEDS,
        artifacts_dir=str(tmp_path),
        scenario_kw={"device": "cpu", "tile": 32})
    assert len(report.seeds) == REALBYTES_SEEDS + 1
    assert not list(tmp_path.iterdir())


# --------------------------------------------- failure artifacts + replay
def order_dependent_scenario(sched):
    """Deliberately broken: returns bytes that depend on the schedule, so
    cross-seed identity fails (the artifact/replay path's test double)."""
    out = []
    for i in range(6):
        sched.schedule(0.0, out.append, i)
    sched.run()
    return {"order": repr(out).encode()}


def always_failing_scenario(sched):
    """Deliberately broken: violates its internal invariant on every
    schedule (the replay-reproduces-the-failure test double)."""
    sched.run()
    assert False, "planted invariant violation"


def racy_scenario(sched):
    """Deliberately racy: unsynchronized writes from spawned threads, so
    the zero-data-race invariant fails."""
    d = racedep.Shared({}, "racy.d")

    def w1():
        d["k"] = 1

    def w2():
        d["k"] = 2

    ts = [racedep.spawn(w1, start=False), racedep.spawn(w2, start=False)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    sched.run()
    return {}


def test_broken_invariant_dumps_artifact_and_replay_command(tmp_path,
                                                            capsys):
    with pytest.raises(schedules.ExplorationFailure) as ei:
        schedules.explore(order_dependent_scenario, seeds=10,
                          artifacts_dir=str(tmp_path))
    err = ei.value
    assert err.seed is not None and err.artifact is not None
    art = json.loads((tmp_path / err.artifact.rsplit("/", 1)[-1])
                     .read_text())
    assert art["seed"] == err.seed
    assert art["scenario"].endswith(":order_dependent_scenario")
    assert art["trace"], "artifact must carry the schedule trace"
    assert "diverged across schedules" in art["error"]
    out = capsys.readouterr().out
    assert "replay:" in out and "--replay" in out and err.artifact in out


def test_replay_reruns_the_recorded_schedule(tmp_path, capsys):
    with pytest.raises(schedules.ExplorationFailure) as ei:
        schedules.explore(always_failing_scenario, seeds=2,
                          artifacts_dir=str(tmp_path))
    artifact = ei.value.artifact
    # the replay command re-raises the original failure, reproducibly
    with pytest.raises(AssertionError, match="planted invariant violation"):
        schedules.replay(artifact)


def test_explore_fails_on_planted_data_race(tmp_path):
    with pytest.raises(schedules.ExplorationFailure, match="data race"):
        schedules.explore(racy_scenario, seeds=1,
                          artifacts_dir=str(tmp_path))
    arts = list(tmp_path.iterdir())
    assert len(arts) == 1
    assert "racy.d" in json.loads(arts[0].read_text())["error"]


def test_replay_result_matches_original_run(tmp_path):
    r1 = schedules._run_one(schedules.sim_fleet_scenario, 5)[0]
    r2 = schedules._run_one(schedules.sim_fleet_scenario, 5)[0]
    assert schedules._digest(r1) == schedules._digest(r2)


# ------------------------------------------------------------------- CLI
def test_cli_explore_and_replay(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert schedules.main(["--explore", "sim", "--seeds", "2",
                           "--artifacts", str(tmp_path / "arts")]) == 0
    assert "ExplorationReport" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        schedules.main([])  # neither --explore nor --replay
