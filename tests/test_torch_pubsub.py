"""Pub/sub delivery semantics — the fault-tolerance invariants, property-based."""
import pytest

from _hypothesis_compat import given, settings, st

from repro_torch.core import Metrics, SimScheduler, Subscription, Topic
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


def make(endpoint, **kw):
    sched = SimScheduler()
    topic = Topic("t", sched)
    dlq = Topic("dlq", sched)
    dead = []
    Subscription(dlq, "dlq-sink", lambda m, c: (dead.append(m.data), c.ack()))
    sub = Subscription(topic, "s", endpoint, dlq=dlq, **kw)
    return sched, topic, sub, dead


def test_happy_path_ack():
    got = []
    sched, topic, sub, _ = make(lambda m, c: (got.append(m.data["i"]), c.ack()))
    for i in range(5):
        topic.publish({"i": i})
    sched.run()
    assert sorted(got) == list(range(5))
    assert sub.stats()["acked"] == 5


def test_nack_redelivers_with_backoff():
    attempts = []

    def ep(m, c):
        attempts.append(sched.now())
        if len(attempts) < 3:
            c.nack("boom")
        else:
            c.ack()

    sched, topic, sub, dead = make(ep, min_backoff=10.0)
    topic.publish({"i": 0})
    sched.run()
    assert len(attempts) == 3
    # exponential backoff: gaps ~10 then ~20
    assert attempts[1] - attempts[0] >= 10.0
    assert attempts[2] - attempts[1] >= 20.0
    assert not dead


def test_max_attempts_dead_letters():
    sched, topic, sub, dead = make(lambda m, c: c.nack("always"),
                                   max_delivery_attempts=3, min_backoff=1.0)
    topic.publish({"i": 7})
    sched.run()
    assert len(dead) == 1 and dead[0]["i"] == 7
    assert sub.stats()["acked"] == 0


def test_ack_deadline_expiry_redelivers():
    """An endpoint that never responds (crashed worker) → redelivery."""
    calls = []

    def ep(m, c):
        calls.append(sched.now())
        if len(calls) == 1:
            return  # first delivery: worker dies, never acks
        c.ack()

    sched, topic, sub, _ = make(ep, ack_deadline=60.0, min_backoff=5.0)
    topic.publish({"i": 0})
    sched.run()
    assert len(calls) == 2
    assert calls[1] >= 60.0  # waited out the deadline
    assert sub.stats()["acked"] == 1


def test_ordering_key_serializes_delivery():
    order = []

    def ep(m, c):
        order.append(m.data["i"])
        # finish after a delay; next keyed message must wait for the ack
        sched.schedule(5.0, c.ack)

    sched, topic, sub, _ = make(ep)
    for i in range(4):
        topic.publish({"i": i}, ordering_key="slide-1")
    sched.run()
    assert order == [0, 1, 2, 3]


def test_flow_control_limits_outstanding():
    inflight = []
    peak = [0]

    def ep(m, c):
        inflight.append(c)
        peak[0] = max(peak[0], len(inflight))
        sched.schedule(10.0, lambda: (inflight.remove(c), c.ack()))

    sched, topic, sub, _ = make(ep, max_outstanding=3)
    for i in range(10):
        topic.publish({"i": i})
    sched.run()
    assert peak[0] <= 3
    assert sub.stats()["acked"] == 10


def test_ordered_nack_redelivers_before_later_keyed_messages():
    """Regression: a nacked ordered message used to re-enqueue into its own
    busy key's backlog and never redeliver. The retry must come back — and
    come back *before* later messages with the same key."""
    got = []

    def ep(m, c):
        got.append(m.data["i"])
        if m.data["i"] == 0 and got.count(0) == 1:
            c.nack("boom")
        else:
            c.ack()

    sched, topic, sub, dead = make(ep, min_backoff=5.0)
    for i in range(3):
        topic.publish({"i": i}, ordering_key="slide-1")
    sched.run()
    assert got == [0, 0, 1, 2]  # retried first; key order preserved
    assert sub.stats()["acked"] == 3
    assert sub.stats()["ordered_backlog"] == 0
    assert not dead


def test_ordered_deadline_expiry_redelivers_and_key_drains():
    """Regression: a deadline-expired ordered delivery wedged its key the
    same way a nack did."""
    calls = []

    def ep(m, c):
        calls.append(m.data["i"])
        if m.data["i"] == 0 and calls.count(0) == 1:
            return  # worker dies holding the keyed message
        c.ack()

    sched, topic, sub, dead = make(ep, ack_deadline=30.0, min_backoff=5.0)
    topic.publish({"i": 0}, ordering_key="k")
    topic.publish({"i": 1}, ordering_key="k")
    sched.run()
    assert calls == [0, 0, 1]
    assert sub.stats()["acked"] == 2
    assert not dead


def test_ordered_dead_letter_releases_key():
    """Regression: a dead-lettered ordered message left its key busy
    forever, stalling every later message with that key."""
    def ep(m, c):
        if m.data["i"] == 0:
            c.nack("poison")
        else:
            c.ack()

    sched, topic, sub, dead = make(ep, max_delivery_attempts=2,
                                   min_backoff=1.0)
    topic.publish({"i": 0}, ordering_key="k")
    topic.publish({"i": 1}, ordering_key="k")
    topic.publish({"i": 2}, ordering_key="k")
    sched.run()
    assert [d["i"] for d in dead] == [0]  # the poison message dead-letters
    assert sub.stats()["acked"] == 2  # …and the key's backlog drains
    assert sub.stats()["ordered_backlog"] == 0


@settings(max_examples=25, deadline=None)
@given(
    n_msgs=st.integers(1, 12),
    fail_pattern=st.lists(st.integers(0, 3), min_size=1, max_size=40),
    n_keys=st.integers(1, 3),
)
def test_ordered_at_least_once_invariant(n_msgs, fail_pattern, n_keys):
    """Property: ordered delivery under any failure pattern still settles
    every message (acked or dead-lettered), never wedges a key, and never
    lets a later message with a key overtake an earlier one's settlement."""
    state = {"calls": 0}
    settled: dict[str, list[int]] = {}

    def ep(m, c):
        k = state["calls"]
        state["calls"] += 1
        mode = fail_pattern[k % len(fail_pattern)]
        if mode == 0:
            settled.setdefault(m.ordering_key, []).append(m.data["i"])
            c.ack()
        elif mode == 1:
            c.nack("injected")
        elif mode == 2:
            raise RuntimeError("crash")
        else:
            pass  # hang → deadline expiry

    sched = SimScheduler()
    topic = Topic("t", sched)
    dlq = Topic("dlq", sched)
    dead = []
    Subscription(dlq, "sink", lambda m, c: (dead.append(m.data["i"]), c.ack()))
    sub = Subscription(topic, "s", ep, dlq=dlq, ack_deadline=30.0,
                       min_backoff=1.0, max_delivery_attempts=4)
    for i in range(n_msgs):
        topic.publish({"i": i}, ordering_key=f"k{i % n_keys}")
    sched.run(max_events=200_000)
    assert sched.idle(), "simulation did not quiesce"
    assert sub.stats()["acked"] + len(dead) == n_msgs
    assert sub.stats()["backlog"] == 0 and sub.stats()["outstanding"] == 0
    assert sub.stats()["ordered_backlog"] == 0, "wedged ordering key"
    for key, acked in settled.items():
        assert acked == sorted(acked), f"key {key} acked out of order"


def test_hedge_fires_duplicate_for_straggler():
    deliveries = []

    def ep(m, c):
        deliveries.append(sched.now())
        if len(deliveries) == 1:
            sched.schedule(500.0, c.ack)  # straggler
        else:
            c.ack()  # hedge finishes fast

    sched, topic, sub, _ = make(ep, hedge_after=50.0, ack_deadline=1000.0)
    topic.publish({"i": 0})
    sched.run()
    assert len(deliveries) == 2
    assert deliveries[1] >= 50.0


def test_hedge_nack_does_not_disturb_original_delivery():
    """Regression: a hedged duplicate shares the original's message_id, and
    its nack used to pop the *original's* outstanding entry and schedule a
    retry while the original was still in flight — double-delivering. A
    failed duplicate must settle itself only; the slow original's own ack
    is the message's one settlement."""
    deliveries = []

    def ep(m, c):
        deliveries.append(sched.now())
        if len(deliveries) == 1:
            sched.schedule(200.0, c.ack)  # slow original, eventually fine
        else:
            c.nack("hedge gave up")  # duplicate fails fast

    sched, topic, sub, dead = make(ep, hedge_after=50.0, ack_deadline=1000.0,
                                   min_backoff=10.0)
    topic.publish({"i": 0})
    sched.run()
    assert len(deliveries) == 2  # original + hedge, no phantom redelivery
    assert sub.stats()["acked"] == 1
    assert sub.stats()["outstanding"] == 0
    assert not dead
    # the duplicate's failure is accounted separately, not as a message nack
    assert sub.metrics.get("sub.s.nacks") == 0
    assert sub.metrics.get("sub.s.hedge_nacks") == 1
    assert "sub.s.deadline_expired" not in sub.metrics.counters


def test_hedge_ack_settles_original_and_cancels_its_timers():
    """When the duplicate wins, the original's deadline timer must die with
    it — no deadline_expired redelivery at t=ack_deadline."""
    deliveries = []
    def ep(m, c):
        deliveries.append(sched.now())
        if len(deliveries) == 1:
            return  # original hangs forever
        c.ack()  # duplicate finishes

    sched, topic, sub, dead = make(ep, hedge_after=20.0, ack_deadline=100.0,
                                   min_backoff=5.0)
    topic.publish({"i": 0})
    sched.run()
    assert len(deliveries) == 2
    assert sub.stats()["acked"] == 1
    assert sub.stats()["outstanding"] == 0
    assert sub.metrics.get("sub.s.hedge_acks") == 1
    assert "sub.s.deadline_expired" not in sub.metrics.counters
    assert not dead


@settings(max_examples=25, deadline=None)
@given(
    n_msgs=st.integers(1, 20),
    fail_pattern=st.lists(st.integers(0, 3), min_size=1, max_size=40),
)
def test_at_least_once_invariant(n_msgs, fail_pattern):
    """Property: whatever the failure pattern, every message is eventually
    acked or dead-lettered — none lost, none stuck."""
    state = {"calls": 0}

    def ep(m, c):
        k = state["calls"]
        state["calls"] += 1
        mode = fail_pattern[k % len(fail_pattern)]
        if mode == 0:
            c.ack()
        elif mode == 1:
            c.nack("injected")
        elif mode == 2:
            raise RuntimeError("crash")
        else:
            pass  # hang → deadline expiry

    sched = SimScheduler()
    topic = Topic("t", sched)
    dlq = Topic("dlq", sched)
    dead = []
    Subscription(dlq, "sink", lambda m, c: (dead.append(m.data["i"]), c.ack()))
    sub = Subscription(topic, "s", ep, dlq=dlq, ack_deadline=30.0,
                       min_backoff=1.0, max_delivery_attempts=4)
    for i in range(n_msgs):
        topic.publish({"i": i})
    sched.run(max_events=200_000)
    assert sched.idle(), "simulation did not quiesce"
    accounted = sub.stats()["acked"] + len(dead)
    assert accounted == n_msgs
    assert sub.stats()["backlog"] == 0 and sub.stats()["outstanding"] == 0
