"""DICOM store subsystem: idempotent STOW, persistent index + crash
rebuild, QIDO filtering/aggregation, indexed WADO, and the event-driven
validation / ML-inference subscribers.

The port's copy of ``tests/test_store_service.py``, on the CPU (conversion
and decode with ``device="cpu"``), plus the inference subscriber's per-frame
stats held exactly to ``repro``'s on the same stored study."""
import pytest

from repro_torch.core import SimScheduler, Subscription, Topic
from repro_torch.core.storage import ObjectStore
from repro_torch.wsi import (ConvertOptions, DicomStoreService,
                             InferenceSubscriber, Part10Index,
                             SyntheticScanner, ValidationService,
                             convert_wsi_to_dicom, write_part10)
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401


@pytest.fixture(scope="module")
def archive():
    # 64-px tiles (the reference's copy uses 256): the CPU's plain entropy
    # decode steps once per symbol of the longest tile
    psv = SyntheticScanner(seed=3).scan(512, 512, 64)
    return convert_wsi_to_dicom(psv, metadata={"slide_id": "X"},
                                options=ConvertOptions(device="cpu"))


def _svc(sched=None):
    sched = sched or SimScheduler()
    store = ObjectStore(sched)
    return DicomStoreService(store.bucket("dicom"), sched), store, sched


def _snapshot(svc, drop=()):
    """Everything QIDO/WADO serve, for byte-identity comparisons."""
    snap = {}
    for study in svc.search_studies():
        snap[study] = {
            "summary": svc.study_summary(study),
            "series": svc.search_series(study),
            "instances": [
                {**{k: v for k, v in m.items() if k not in drop},
                 "blob": svc.retrieve(m["sop_instance_uid"]),
                 "frame0": svc.retrieve_frame(m["sop_instance_uid"], 0)}
                for m in svc.search_instances(study)],
        }
    return snap


def _instance(study, series, sop, patient="ANON", **kw):
    return write_part10(frames=[b"\x00" * 48], rows=4, cols=4, total_rows=4,
                        total_cols=4, transfer_syntax="1.2.840.10008.1.2.1",
                        study_uid=study, series_uid=series,
                        sop_instance_uid=sop, patient_id=patient, **kw)


# --------------------------------------------------------------------------
# STOW idempotency
# --------------------------------------------------------------------------
def test_restow_is_idempotent_and_byte_identical(archive):
    svc, _, sched = _svc()
    sops = svc.store_study_archive("studies/x", archive)
    sched.run()
    clean = _snapshot(svc)
    assert len(sops) == 2  # two pyramid levels

    again = svc.store_study_archive("studies/x", archive)
    sched.run()
    assert again == sops
    assert _snapshot(svc) == clean
    (study,) = svc.search_studies()
    instances = svc.search_instances(study)
    assert len(instances) == 2  # no duplicate SOP UIDs
    assert svc.metrics.get("dicomstore.replaced") == 2


def test_identical_restow_does_not_republish(archive):
    svc, _, sched = _svc()
    events = []
    Subscription(svc.topic, "probe",
                 lambda m, c: (events.append(m.data["sop_instance_uid"]),
                               c.ack()))
    svc.store_study_archive("studies/x", archive)
    svc.store_study_archive("studies/x", archive)
    sched.run()
    assert sorted(events) == sorted(set(events))  # one event per instance


def test_redelivered_archive_through_real_subscription(archive):
    """At-least-once ingest: the first delivery stores but 'crashes' before
    acking; the redelivery stores again — QIDO must not see duplicates."""
    svc, store, sched = _svc()
    arrivals = Topic("study-arrivals", sched, store.metrics)
    attempts = []

    def ingest(msg, ctx):
        svc.store_study_archive(msg.data["key"], msg.data["archive"])
        attempts.append(ctx.attempt)
        if ctx.attempt >= 2:
            ctx.ack()

    Subscription(arrivals, "store-ingest", ingest, ack_deadline=30.0)
    arrivals.publish({"key": "studies/x", "archive": archive})
    sched.run()

    assert len(attempts) >= 2  # the redelivery actually happened
    (study,) = svc.search_studies()
    sops = [m["sop_instance_uid"] for m in svc.search_instances(study)]
    assert len(sops) == len(set(sops)) == 2


# --------------------------------------------------------------------------
# persistent index: crash + rebuild
# --------------------------------------------------------------------------
def test_crash_rebuild_from_checkpoint_is_byte_identical(archive):
    svc, store, sched = _svc()
    svc.store_study_archive("studies/x", archive)
    clean = _snapshot(svc)

    svc2 = DicomStoreService(store.bucket("dicom"), sched)  # fresh process
    assert svc2.search_studies() == []
    reparsed = svc2.rebuild_index()
    assert reparsed == 0  # checkpoint covered everything
    assert _snapshot(svc2) == clean


def test_crash_rebuild_without_checkpoint_rescans_blobs(archive):
    svc, store, sched = _svc()
    svc.store_study_archive("studies/x", archive)
    clean = _snapshot(svc, drop=("source",))

    bucket = store.bucket("dicom")
    bucket.delete(DicomStoreService.INDEX_KEY)  # checkpoint lost too
    svc2 = DicomStoreService(bucket, sched)
    reparsed = svc2.rebuild_index()
    assert reparsed == 2  # every blob re-indexed from its bytes
    # identical modulo provenance (the source label isn't in the blobs)
    assert _snapshot(svc2, drop=("source",)) == clean


def test_rebuild_drops_stale_checkpoint_entries(archive):
    svc, store, sched = _svc()
    sops = svc.store_study_archive("studies/x", archive)
    svc.delete_instance(sops[0])
    # checkpoint still lists the deleted instance; the blob is gone
    svc2 = DicomStoreService(store.bucket("dicom"), sched)
    svc2.rebuild_index()
    (study,) = svc2.search_studies()
    assert [m["sop_instance_uid"] for m in svc2.search_instances(study)] \
        == sops[1:]


# --------------------------------------------------------------------------
# QIDO: filters match any instance, stable order, aggregation
# --------------------------------------------------------------------------
def test_search_studies_matches_patient_on_any_instance():
    svc, _, _ = _svc()
    svc.store_instance(_instance("1.2.3", "1.2.3.1", "1.2.3.1.1", "ALICE"))
    svc.store_instance(_instance("1.2.3", "1.2.3.2", "1.2.3.2.1", "BOB"))
    svc.store_instance(_instance("1.2.9", "1.2.9.1", "1.2.9.1.1", "CAROL"))
    # the seed judged patient_id from the first stored instance only
    assert svc.search_studies(patient_id="BOB") == ["1.2.3"]
    assert svc.search_studies(patient_id="ALICE") == ["1.2.3"]
    assert svc.search_studies(patient_id="CAROL") == ["1.2.9"]
    assert svc.search_studies(patient_id="NOBODY") == []
    assert svc.search_studies() == ["1.2.3", "1.2.9"]


def test_qido_results_stable_under_arrival_order():
    orders = [(1, 2, 3), (3, 1, 2), (2, 3, 1)]
    snaps = []
    for order in orders:
        svc, _, _ = _svc()
        for i in order:
            svc.store_instance(_instance("1.2.3", f"1.2.3.{(i + 1) // 2}",
                                         f"1.2.3.0.{i}", "ANON",
                                         instance_number=i))
        snaps.append((svc.search_studies(),
                      [m["sop_instance_uid"]
                       for m in svc.search_instances("1.2.3")],
                      svc.search_series("1.2.3")))
    assert snaps[0] == snaps[1] == snaps[2]


def test_qido_filters_and_aggregation(archive):
    svc, _, sched = _svc()
    svc.store_study_archive("studies/x", archive)
    (study,) = svc.search_studies()
    assert svc.search_studies(modality="SM") == [study]
    assert svc.search_studies(modality="CT") == []
    assert svc.search_studies(study_date="20220101") == [study]
    assert svc.search_studies(study_date="19990101") == []
    assert svc.search_studies(modality="SM", patient_id="ANON") == [study]

    summary = svc.study_summary(study)
    assert summary["n_instances"] == 2 and summary["n_series"] == 1
    assert summary["modalities"] == ["SM"]
    assert summary["total_frames"] == sum(
        m["frames"] for m in svc.search_instances(study))
    (series,) = svc.search_series(study)
    assert series["n_instances"] == 2
    assert svc.search_series(study, modality="CT") == []


# --------------------------------------------------------------------------
# WADO: indexed frame retrieval
# --------------------------------------------------------------------------
def test_retrieve_frame_uses_cached_index(archive):
    svc, _, _ = _svc()
    sops = svc.store_study_archive("studies/x", archive)
    idx = Part10Index(svc.retrieve(sops[0]))
    for i in range(idx.n_frames):
        assert svc.retrieve_frame(sops[0], i) == idx.read_frame(i)
    assert svc.metrics.get("dicomstore.wado_index_misses") == 1
    assert svc.metrics.get("dicomstore.wado_index_hits") \
        == idx.n_frames - 1
    with pytest.raises(KeyError):
        svc.retrieve_frame("9.9.9", 0)


# --------------------------------------------------------------------------
# event-driven subscribers
# --------------------------------------------------------------------------
def test_validation_subscriber_quarantines_rotted_instance(archive):
    svc, store, sched = _svc()
    dlq = store.bucket("dicom-dlq")
    validator = ValidationService(svc, dlq)
    sops = svc.store_study_archive("studies/x", archive)
    sched.run()
    assert sorted(validator.checked) == sorted(sops)
    assert validator.quarantined == []

    # bit-rot: destroy the stored blob, then the event is redelivered
    meta = next(m for m in svc.search_instances(svc.search_studies()[0])
                if m["sop_instance_uid"] == sops[0])
    svc.bucket.put(meta["key"], b"\x00" * 200)
    svc.topic.publish(meta)
    sched.run()

    assert [s for s, _ in validator.quarantined] == [sops[0]]
    assert dlq.exists(f"quarantine/{sops[0]}.dcm")
    (study,) = svc.search_studies()
    remaining = [m["sop_instance_uid"] for m in svc.search_instances(study)]
    assert remaining == sops[1:]  # QIDO stops serving it
    with pytest.raises(KeyError):
        svc.retrieve(sops[0])


def test_validation_sweep_catches_rot_without_events(archive):
    svc, store, sched = _svc()
    validator = ValidationService(svc, store.bucket("dicom-dlq"))
    sops = svc.store_study_archive("studies/x", archive)
    sched.run()
    meta = next(m for m in svc.search_instances(svc.search_studies()[0])
                if m["sop_instance_uid"] == sops[1])
    svc.bucket.put(meta["key"], b"not dicom at all")
    assert validator.sweep() == 1
    assert [s for s, _ in validator.quarantined] == [sops[1]]
    assert validator.sweep() == 0  # stable after quarantine


def test_inference_subscriber_scores_decoded_frames_via_wado(archive):
    from repro_torch.wsi import decode_tile

    svc, _, sched = _svc()
    ml = InferenceSubscriber(svc, max_frames=2, device="cpu")
    sops = svc.store_study_archive("studies/x", archive)
    sched.run()
    assert sorted(ml.predictions) == sorted(sops)
    for sop, pred in ml.predictions.items():
        n = next(m["frames"] for s in svc.search_studies()
                 for m in svc.search_instances(s)
                 if m["sop_instance_uid"] == sop)
        assert pred["frames_scored"] == min(n, 2)
        # the subscriber decodes with the batched path (>1 frame pulled);
        # per-tile decode of the same WADO bytes must yield the same stats
        assert pred["pixel_stats"] == [
            InferenceSubscriber.frame_stats(
                decode_tile(svc.retrieve_frame(sop, i), device="cpu"))
            for i in range(pred["frames_scored"])]
        for st in pred["pixel_stats"]:
            assert 0 <= st["min"] <= st["mean"] <= st["max"] <= 255


def test_identity_move_leaves_no_ghost_study():
    """Re-storing a SOP under a new study must fully relocate it — the old
    study disappears from QIDO instead of lingering empty."""
    svc, _, _ = _svc()
    svc.store_instance(_instance("1.2.3", "1.2.3.1", "1.2.3.1.1"))
    svc.store_instance(_instance("1.2.4", "1.2.4.1", "1.2.3.1.1"))
    assert svc.search_studies() == ["1.2.4"]
    for study in svc.search_studies():
        assert svc.study_summary(study)["n_instances"] == 1
    assert len(svc.bucket.list(svc.PREFIX)) == 1  # old blob deleted


def test_corrupt_archive_member_is_rejected(archive):
    svc, _, _ = _svc()
    with pytest.raises(ValueError, match="corrupt Part-10"):
        svc.store_instance(b"\x00" * 200)


def test_inference_stats_equal_repro_on_the_same_study():
    """Same slide, same pinned UIDs: both converters store the same study,
    and both inference subscribers score the same frames with the same
    per-frame stats (exact)."""
    import repro.core as rcore
    import repro.wsi as rwsi
    from _torch_spine import pinned_convert

    psv = SyntheticScanner(seed=3).scan(512, 512, 64)
    meta = {"slide_id": "X", "format": "psv"}
    tar = pinned_convert(convert_wsi_to_dicom, ConvertOptions,
                         device="cpu")(psv, meta)
    assert tar == pinned_convert(rwsi.convert_wsi_to_dicom,
                                 rwsi.ConvertOptions)(psv, meta)

    svc, _, sched = _svc()
    ml = InferenceSubscriber(svc, max_frames=4, device="cpu")
    svc.store_study_archive("studies/x", tar)
    sched.run()

    rsched = rcore.SimScheduler()
    rsvc = rwsi.DicomStoreService(
        rcore.ObjectStore(rsched).bucket("dicom"), rsched)
    rml = rwsi.InferenceSubscriber(rsvc, max_frames=4)
    rsvc.store_study_archive("studies/x", tar)
    rsched.run()

    assert ml.predictions and ml.predictions == rml.predictions
