"""Object store semantics on the port: creation notifications, idempotent
writes, lifecycle tiers.

The port's copy of the ``ObjectStore`` cases of
``tests/test_storage_dicom.py``; its codec cases are the port's codec tests
(``tests/test_torch_convert.py``, ``tests/test_torch_decode.py``)."""
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from repro_torch.core import (LifecycleRule, SimScheduler,  # noqa: F401
                              Subscription, Topic)
from repro_torch.core.storage import ObjectStore


def test_put_emits_creation_notification():
    sched = SimScheduler()
    store = ObjectStore(sched)
    bucket = store.bucket("landing")
    topic = Topic("t", sched, store.metrics)
    got = []
    Subscription(topic, "s", lambda m, c: (got.append(m.data), c.ack()))
    bucket.add_notification(topic)
    bucket.put("slides/a.psv", b"hello", {"slide_id": "A"})
    sched.run()
    assert len(got) == 1
    evt = got[0]
    assert evt["bucket"] == "landing" and evt["name"] == "slides/a.psv"
    assert evt["eventType"] == "OBJECT_FINALIZE"
    assert evt["metadata"]["slide_id"] == "A"


def test_identical_content_write_is_idempotent():
    sched = SimScheduler()
    store = ObjectStore(sched)
    bucket = store.bucket("b")
    topic = Topic("t", sched, store.metrics)
    got = []
    Subscription(topic, "s", lambda m, c: (got.append(1), c.ack()))
    bucket.add_notification(topic)
    bucket.put("x", b"same")
    bucket.put("x", b"same")  # retried/hedged conversion output
    bucket.put("x", b"different")
    sched.run()
    assert len(got) == 2  # second identical write did not re-notify
    assert store.metrics.get("bucket.b.idempotent_skips") == 1


def test_lifecycle_tiers_by_age():
    sched = SimScheduler()
    store = ObjectStore(sched)
    b = store.bucket("b")
    b.add_lifecycle_rule(LifecycleRule(100.0, "COLDLINE"))
    b.add_lifecycle_rule(LifecycleRule(1000.0, "ARCHIVE"))
    b.put("old", b"1")
    sched.run(until=150.0)
    b.put("new", b"2")
    b.apply_lifecycle()
    assert b.get("old").storage_class == "COLDLINE"
    assert b.get("new").storage_class == "STANDARD"
    sched.run(until=2000.0)
    b.apply_lifecycle()
    assert b.get("old").storage_class == "ARCHIVE"
