"""Fault-injection regression tier for the converter fleet.

Deterministic (``SimScheduler``) failure scenarios over the full pipeline:
an instance killed mid-conversion requeues its work exactly once with the
ordered key released and no DLQ entry; scripted broker faults (dropped,
delayed, duplicated deliveries) lose nothing and double-convert nothing;
backpressure sheds re-enter through budget-exempt requeues without ever
dead-lettering; and the real-bytes gauntlet — actual JPEG/DICOM conversion
with pinned UIDs through a sharded store under faults + instance kill +
shard crash — emits study tars byte-identical to a serial (no
infrastructure) conversion of the same slides."""
import hashlib
import json

import pytest

from repro_torch.core import (ConversionPipeline, DeliveryFaults, SimScheduler)
from repro_torch.core.pipeline import derive_out_key
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


# ------------------------------------------------------------ kill semantics
def test_kill_mid_conversion_requeues_once_releases_key_no_dlq():
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=50.0, cold_start=5.0, max_instances=1,
        min_backoff=5.0, subscribers=False, fleet={}, ordered_ingest=True)
    pipe.ingest("scans/a.psv", b"aaaa")
    sched.schedule(20.0, pipe.service.kill_instance)  # mid-conversion
    sched.run()
    # requeued exactly once inside the fleet — the broker never saw a
    # failure, so there is no retry, no DLQ entry, and the ack settled
    # the delivery on the re-run
    assert pipe.metrics.get("svc.wsi2dcm.requeued") == 1
    assert pipe.metrics.get("svc.wsi2dcm.killed") == 1
    assert pipe.dead_lettered == []
    assert pipe.metrics.get("sub.wsi2dcm-push.acks") == 1
    assert pipe.metrics.get("sub.wsi2dcm-push.nacks") == 0
    # ordered key released on ack: a later event for the same object is
    # deliverable (nothing parked, nothing busy)
    assert pipe.subscription._ordered_busy == set()
    assert pipe.subscription.stats()["ordered_backlog"] == 0


def test_kill_during_cold_start_loses_nothing():
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=30.0, cold_start=10.0, max_instances=2,
        subscribers=False, fleet={}, ordered_ingest=True)
    for i in range(4):
        pipe.ingest(f"scans/s{i}.psv", bytes([i + 1]) * 8)
    sched.schedule(5.0, pipe.service.kill_instance)  # still starting
    sched.run()
    assert pipe.metrics.get("sub.wsi2dcm-push.acks") == 4
    assert pipe.dead_lettered == []


# ----------------------------------------------------------- delivery faults
def test_scripted_faults_zero_lost_zero_double():
    runs = []
    faults = (DeliveryFaults()
              .drop("s0", attempts=(1,))
              .duplicate("s1", lag=1.0)
              .delay("s2", by=200.0))  # past the 120 s ack deadline
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=lambda ev: runs.append(ev["name"]) or 20.0,
        cold_start=5.0, max_instances=4, ack_deadline=120.0, min_backoff=5.0,
        subscribers=False, fleet={}, ordered_ingest=True,
        delivery_faults=faults)
    for i in range(4):
        pipe.ingest(f"scans/s{i}.psv", bytes([i + 1]) * 8)
    sched.run()
    assert dict(faults.injected) == {"drop": 1, "duplicate": 1, "delay": 1}
    # zero lost: every slide converted and settled; zero double: the
    # duplicated and late deliveries deduped at fleet admission
    assert sorted(runs) == [f"scans/s{i}.psv" for i in range(4)]
    assert pipe.metrics.get("sub.wsi2dcm-push.acks") == 4
    assert pipe.metrics.get("svc.wsi2dcm.duplicates") >= 1
    assert pipe.dead_lettered == []
    assert pipe.subscription.stats()["outstanding"] == 0


def test_seeded_random_faults_converge():
    for seed in (3, 17):
        faults = DeliveryFaults.random(seed, p_drop=0.2, p_duplicate=0.2,
                                       p_delay=0.3, max_delay=150.0)
        sched = SimScheduler()
        pipe = ConversionPipeline(
            sched, service_time=15.0, cold_start=5.0, max_instances=4,
            ack_deadline=90.0, min_backoff=5.0, subscribers=False,
            fleet={}, ordered_ingest=True, delivery_faults=faults)
        n = 10
        for i in range(n):
            pipe.ingest(f"scans/s{i:02d}.psv", bytes([i + 1]) * 8)
        sched.run()
        assert pipe.metrics.get("sub.wsi2dcm-push.acks") == n
        assert pipe.dead_lettered == []
        assert pipe.subscription.stats()["outstanding"] == 0
        assert pipe.subscription.stats()["backlog"] == 0


# ------------------------------------------------------------- backpressure
def test_backpressure_sheds_without_dead_lettering():
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=30.0, cold_start=5.0, max_instances=2,
        min_backoff=5.0, max_delivery_attempts=3, subscribers=False,
        fleet=dict(shed_backlog=3), ordered_ingest=True)
    n = 10
    for i in range(n):
        pipe.ingest(f"burst/s{i:02d}.psv", bytes([i + 1]) * 8)
    sched.run()
    shed = pipe.metrics.get("svc.wsi2dcm.shed")
    assert shed > 0, "overload never shed"
    # sheds came back as budget-exempt requeues (same attempt number), so
    # even with a 3-attempt budget nothing dead-letters and all complete
    assert pipe.metrics.get("sub.wsi2dcm-push.requeues") >= shed
    assert pipe.dead_lettered == []
    assert pipe.metrics.get("sub.wsi2dcm-push.acks") == n
    # in-flight work is never shed: admitted requests all completed
    assert pipe.metrics.get("svc.wsi2dcm.completed") == n


def test_dlq_depth_shedding_holds_new_work_back():
    # a poison slide exhausts its budget and dead-letters; with
    # shed_dlq_depth=1 the fleet then sheds new work (which retries
    # budget-exempt) instead of accepting it into a failing system
    def service(event):
        if event["name"].startswith("bad/"):
            raise RuntimeError("poison slide")
        return 10.0

    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, service_time=service, cold_start=2.0,
        max_instances=2, min_backoff=5.0, max_delivery_attempts=2,
        subscribers=False, ordered_ingest=True,
        fleet=dict(shed_dlq_depth=1))
    pipe.ingest("bad/p.psv", b"pp")
    sched.run()
    assert len(pipe.dead_lettered) == 1
    # the DLQ threshold is now tripped: a healthy slide sheds (retrying
    # budget-exempt on its 2-attempt budget) until the gate lifts, then
    # completes — it must never dead-letter while being held back
    pipe.ingest("ok/q.psv", b"qq")
    sched.schedule(12.0, lambda: setattr(pipe.service, "shed_dlq_depth", 10))
    sched.run()
    assert pipe.metrics.get("svc.wsi2dcm.shed") >= 2
    assert pipe.metrics.get("sub.wsi2dcm-push.acks") == 1
    assert [e["name"] for e, _ in pipe.dead_lettered] == ["bad/p.psv"]


# ------------------------------------------------- faults as span events
def test_fault_and_kill_span_events():
    """Every injected broker fault and the instance kill show up as
    structured span events in the delivery/request spans (PR 10): chaos is
    visible in the same trace tree the dashboard renders, not only as
    counters."""
    from repro_torch.core import tracing

    faults = (DeliveryFaults()
              .drop("s0", attempts=(1,))
              .duplicate("s1", lag=1.0)
              .delay("s2", by=200.0))
    sched = SimScheduler()
    with tracing.capture(now=sched.now) as tracer:
        pipe = ConversionPipeline(
            sched, service_time=40.0, cold_start=5.0, max_instances=2,
            ack_deadline=120.0, min_backoff=5.0, subscribers=False,
            fleet={}, ordered_ingest=True, delivery_faults=faults)
        for i in range(3):
            pipe.ingest(f"scans/s{i}.psv", bytes([i + 1]) * 8)
        sched.schedule(20.0, pipe.service.kill_instance)  # mid-conversion
        sched.run()
    assert pipe.metrics.get("sub.wsi2dcm-push.acks") == 3
    assert pipe.metrics.get("svc.wsi2dcm.killed") >= 1

    events = {}  # event name -> list of (span name, attrs)
    for sp in tracer.spans:
        for _, name, attrs in sp.events:
            events.setdefault(name, []).append((sp.name, attrs))
    # each scripted fault annotated the delivery attempt it hit
    assert events["fault.drop"] == [("sub.wsi2dcm-push.deliver",
                                     {"attempt": 1})]
    assert events["fault.delay"] == [("sub.wsi2dcm-push.deliver",
                                      {"by": 200.0})]
    assert events["fault.duplicate"] == [("sub.wsi2dcm-push.deliver",
                                          {"lag": 1.0})]
    # the kill requeued its victims on their open request spans...
    assert {n for n, _ in events["fleet.kill_requeue"]} == \
        {"svc.wsi2dcm.request"}
    assert all(a["instance"] >= 0 for _, a in events["fleet.kill_requeue"])
    # ...and the dead serve attempts settled as killed handle spans
    killed = [sp for sp in tracer.spans if sp.status == "killed"]
    assert killed and {sp.name for sp in killed} == {"svc.wsi2dcm.handle"}
    assert len(killed) == len(events["fleet.kill_requeue"])


# ---------------------------------------------------- real-bytes gauntlet
def _uids_for(slide_id: str) -> list[str]:
    h = hashlib.sha256(slide_id.encode()).hexdigest()
    return ["2.25." + str(int(h[:24], 16)),
            "2.25." + str(int(h[24:48], 16))]


@pytest.fixture(scope="module")
def gauntlet():
    """Real conversions under SimScheduler with faults, a kill, and a
    4-shard store; plus the serial baseline of the same slides."""
    from repro_torch.wsi import SyntheticScanner
    from repro_torch.wsi.convert import ConvertOptions, convert_wsi_to_dicom
    from repro_torch.wsi.formats import sniff

    def convert(data, meta):
        opt = ConvertOptions(
            manifest={"uids": json.dumps(_uids_for(meta["slide_id"]))},
            device="cpu")
        return convert_wsi_to_dicom(data, meta, options=opt)

    scanner = SyntheticScanner(seed=11)
    slides = {f"scans/s{i}.psv": scanner.scan(256, 256, 256)
              for i in range(3)}
    meta = {k: {"slide_id": k, "tenant": ("lab-a", "lab-b")[i % 2]}
            for i, k in enumerate(slides)}
    baseline = {}
    for k, d in slides.items():
        m = dict(meta[k])
        m.setdefault("format", sniff(d))
        baseline[k] = convert(d, m)

    faults = (DeliveryFaults()
              .drop("s0", attempts=(1,))
              .duplicate("s1", lag=1.0)
              .delay("s2", by=200.0))
    sched = SimScheduler()
    pipe = ConversionPipeline(
        sched, convert=convert, cold_start=12.0, max_instances=4,
        ack_deadline=120.0, min_backoff=5.0, fleet={}, ordered_ingest=True,
        store_shards=4, delivery_faults=faults, device="cpu")
    for k, d in slides.items():
        pipe.ingest(k, d, meta[k])
    sched.schedule(5.0, pipe.service.kill_instance)
    sched.run()
    return pipe, slides, baseline, faults


def test_gauntlet_zero_lost_zero_double_converted(gauntlet):
    pipe, slides, _, faults = gauntlet
    assert pipe.dead_lettered == []
    assert sum(faults.injected.values()) == 3
    assert pipe.metrics.get("svc.wsi2dcm.killed") == 1
    assert len(pipe.dicom.list()) == len(slides)
    # one study-tar write per slide: a re-converted duplicate would either
    # bump writes (different bytes) or idempotent_skips (same bytes) — the
    # former must not happen at all
    assert pipe.metrics.get("bucket.dicom-store.writes") == len(slides)


def test_gauntlet_study_tars_byte_identical_to_serial(gauntlet):
    pipe, slides, baseline, _ = gauntlet
    for k in slides:
        assert pipe.dicom.get(derive_out_key(k)).data == baseline[k], \
            f"fleet output differs from serial conversion for {k}"


def test_gauntlet_sharded_store_serves_all_studies(gauntlet):
    pipe, slides, _, _ = gauntlet
    ss = pipe.store_service
    studies = ss.search_studies()
    assert len(studies) == len(slides)
    assert sum(ss.shard_distribution()) == sum(
        len(ss.search_instances(u)) for u in studies)
    # downstream subscribers attached to the shared topic saw every store
    assert len(pipe.validator.checked) == sum(ss.shard_distribution())


def test_gauntlet_crashed_shard_rebuilds_byte_identical(gauntlet):
    pipe, _, _, _ = gauntlet
    ss = pipe.store_service
    uid = ss.search_studies()[0]
    shard_i = ss.shard_index_for(uid)
    qido = ss.search_instances(uid)
    wado = {m["sop_instance_uid"]: ss.retrieve(m["sop_instance_uid"])
            for m in qido}
    ss.crash_shard(shard_i)
    assert ss.search_instances(uid) == [], "crash left state behind"
    ss.rebuild_index()
    assert ss.search_instances(uid) == qido
    for sop, blob in wado.items():
        assert ss.retrieve(sop) == blob
