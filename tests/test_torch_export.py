"""Export subsystem: event-driven DICOM → tiled-TIFF retrieval — QIDO/WADO
reads, deterministic TIFF output (repeat + crash-rebuild byte identity),
actionable DLQ reasons for corrupt frames, auto-export fan-out, and the
full-circle re-ingestion of an exported TIFF.

The port's copy of ``tests/test_export.py``, on the CPU (``device="cpu"``
for conversion and decode). Slides use ``TILE`` = 64-px tiles where the
reference uses 256: the CPU's plain entropy decode steps once per symbol of
the longest tile. Frame counts follow (a 512² slide: 64 + 16 frames). Plus
the exported TIFF bytes held to ``repro``'s on the same stored study."""
import numpy as np
import pytest

from repro_torch.core import ConversionPipeline, RealScheduler, SimScheduler
from repro_torch.core.storage import ObjectStore
from repro_torch.wsi import (ConvertOptions, DicomStoreService, ExportService,
                       SyntheticScanner, convert_wsi_to_dicom, decode_tile,
                       open_slide, study_levels, write_part10)
from repro_torch.wsi.dicom import TS_JPEG_BASELINE
from repro_torch.wsi.formats import TiffSlideReader
from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401

TILE = 64


def _stored_study(hw=512, seed=3, **convert_kw):
    psv = SyntheticScanner(seed=seed).scan(hw, hw, TILE)
    archive = convert_wsi_to_dicom(
        psv, {"slide_id": "exp"},
        options=ConvertOptions(device="cpu", **convert_kw))
    sched = SimScheduler()
    store = ObjectStore(sched)
    svc = DicomStoreService(store.bucket("dicom"), sched)
    svc.store_study_archive("studies/exp.tar", archive)
    (study,) = svc.search_studies()
    return psv, svc, store, study


def _derived_bytes(derived):
    return {k: derived.get(k).data for k in derived.list()}


# --------------------------------------------------------------------------
# the export itself
# --------------------------------------------------------------------------
def test_export_study_writes_reopenable_level_tiffs():
    _, svc, store, study = _stored_study()
    exporter = ExportService(svc, store.bucket("derived"), device="cpu")
    keys = exporter.export_study(study)
    assert keys == [f"{study}/level_0.tiff", f"{study}/level_1.tiff"]
    for li, key in enumerate(keys):
        rd = open_slide(store.bucket("derived").get(key).data)
        assert isinstance(rd, TiffSlideReader)
        assert (rd.H, rd.W, rd.tile) == (512 >> li, 512 >> li, TILE)
        # provenance rides in the Aperio-style ImageDescription
        assert rd.metadata["vendor"] == "repro-dicom2tiff"
        assert rd.metadata["study"] == study
        assert rd.metadata["level"] == str(li)
    assert exporter.exported == [(study, tuple(keys))]


def test_exported_pixels_match_wado_frame_decode():
    """The TIFF tiles are exactly the decoded WADO frames, row-major."""
    _, svc, store, study = _stored_study()
    exporter = ExportService(svc, store.bucket("derived"), device="cpu")
    (key0, _) = exporter.export_study(study)
    rd = open_slide(store.bucket("derived").get(key0).data)
    meta = svc.search_instances(study)[0]
    sop = meta["sop_instance_uid"]
    bh, bw = rd.grid
    for r in range(bh):
        for c in range(bw):
            frame = svc.retrieve_frame(sop, r * bw + c)
            np.testing.assert_array_equal(rd.read_tile(r, c),
                                          decode_tile(frame, device="cpu"))


def test_native_study_exports_lossless_pixels():
    """jpeg=False studies export through the native path — the TIFF pixels
    equal the original scan exactly (no transform loss anywhere)."""
    psv, svc, store, study = _stored_study(jpeg=False)
    exporter = ExportService(svc, store.bucket("derived"), device="cpu")
    keys = exporter.export_study(study)
    rd = open_slide(store.bucket("derived").get(keys[0]).data)
    src = open_slide(psv)
    for (rc, tile) in src.tiles():
        np.testing.assert_array_equal(rd.read_tile(*rc), tile)


def test_repeated_and_post_rebuild_exports_are_byte_identical():
    _, svc, store, study = _stored_study()
    exporter = ExportService(svc, store.bucket("derived"), device="cpu")
    exporter.export_study(study)
    clean = _derived_bytes(exporter.derived)

    # full re-derivation forced: the decode + write_tiff pipeline itself
    # must be deterministic (content-addressed no-op, no re-notify)
    exporter.export_study(study, skip_unchanged=False)
    assert _derived_bytes(exporter.derived) == clean
    assert store.metrics.get("bucket.derived.idempotent_skips") >= 2

    # default path short-circuits on the recorded content generation —
    # no WADO fetch, no decode (frames_decoded unchanged)
    before = svc.metrics.get("pipeline.export.frames_decoded")
    keys = exporter.export_study(study)
    assert svc.metrics.get("pipeline.export.levels_unchanged") == 2
    assert svc.metrics.get("pipeline.export.frames_decoded") == before
    assert keys == sorted(clean)  # skipped levels still report their keys

    # simulated crash: fresh service over the same bucket + rebuilt index
    svc2 = DicomStoreService(store.bucket("dicom"), svc.scheduler)
    svc2.rebuild_index()
    exporter2 = ExportService(svc2, store.bucket("derived2"), device="cpu")
    exporter2.export_study(study)
    assert _derived_bytes(exporter2.derived) == {
        k: v for k, v in clean.items()}


def test_sub_tile_levels_are_skipped_not_fatal():
    """A level smaller than one tile stores zero frames — export skips it
    (there are no pixels) and records the skip."""
    _, svc, store, study = _stored_study(min_level_size=32)
    exporter = ExportService(svc, store.bucket("derived"), device="cpu")
    keys = exporter.export_study(study)
    assert [k.rsplit("/", 1)[1] for k in keys] == \
        [f"level_{i}.tiff" for i in range(4)]  # level_4 (32² < tile) skipped
    assert svc.metrics.get("pipeline.export.levels_skipped") == 1


def test_unknown_study_raises_key_error():
    _, svc, store, _ = _stored_study()
    exporter = ExportService(svc, store.bucket("derived"), device="cpu")
    with pytest.raises(KeyError, match="unknown study"):
        exporter.export_study("2.25.404")


# --------------------------------------------------------------------------
# the event-driven hop (pipeline wiring)
# --------------------------------------------------------------------------
def test_request_export_through_pipeline_topic():
    sched = SimScheduler()
    pipe = ConversionPipeline(sched, device="cpu")
    archive = convert_wsi_to_dicom(
        SyntheticScanner(seed=4).scan(512, 512, TILE), {"slide_id": "s"},
        ConvertOptions(device="cpu"))
    pipe.dicom.put("studies/s.dcm", archive)  # → store-ingest hop
    sched.run()
    (study,) = pipe.store_service.search_studies()
    assert pipe.derived.list() == []  # no auto-export by default

    pipe.request_export(study)
    sched.run()
    assert pipe.derived.list() == [f"{study}/level_0.tiff",
                                   f"{study}/level_1.tiff"]
    g = pipe.metrics.get
    assert g("pipeline.export.requests") == 1
    assert g("pipeline.export.frames_decoded") == 80  # 64 + 16 frames
    assert g("pipeline.export.bytes_written") > 0
    assert g("topic.export-request.published") == 1


def test_auto_export_triggers_on_instance_stored():
    sched = SimScheduler()
    pipe = ConversionPipeline(sched, auto_export=True, device="cpu")
    archive = convert_wsi_to_dicom(
        SyntheticScanner(seed=6).scan(512, 512, TILE), {"slide_id": "s"},
        ConvertOptions(device="cpu"))
    pipe.dicom.put("studies/s.dcm", archive)
    sched.run()
    (study,) = pipe.store_service.search_studies()
    # every stored instance republished the request; the repeats skip on
    # the recorded content generation instead of re-decoding every level
    assert pipe.derived.list() == [f"{study}/level_0.tiff",
                                   f"{study}/level_1.tiff"]
    assert pipe.metrics.get("pipeline.export.requests") == 2
    assert pipe.metrics.get("pipeline.export.frames_decoded") == 80
    assert pipe.metrics.get("pipeline.export.levels_unchanged") == 2


def test_corrupt_frame_dead_letters_with_actionable_reason():
    """A stored instance whose frame bytes rot into undecodable JPEG must
    exhaust export retries and land in the export DLQ carrying the
    decoder's corrupt-JPEG reason."""
    sched = SimScheduler()
    pipe = ConversionPipeline(sched, max_delivery_attempts=2,
                              min_backoff=0.1, max_backoff=0.1,
                              subscribers=False, device="cpu")
    # SOI marker present (so the deep-verify path keeps it) but garbage after
    bad = b"\xff\xd8" + b"\x99" * 40
    blob = write_part10(frames=[bad], rows=8, cols=8, total_rows=8,
                        total_cols=8, transfer_syntax=TS_JPEG_BASELINE,
                        study_uid="1.2.9", series_uid="1.2.9.1",
                        sop_instance_uid="1.2.9.1.1")
    pipe.store_service.store_instance(blob)
    pipe.request_export("1.2.9")
    sched.run()
    assert pipe.derived.list() == []
    assert pipe.metrics.get("pipeline.export.dead_lettered") == 1
    ((event, reason),) = pipe.export_dead_lettered
    assert event == {"study_uid": "1.2.9"}
    assert "corrupt JPEG" in reason


# --------------------------------------------------------------------------
# full circle: scan → convert → store → export → re-ingest
# --------------------------------------------------------------------------
def test_full_circle_export_reingests_through_sniffing_pipeline():
    sched = RealScheduler(workers=4)
    pipe = ConversionPipeline(
        sched, convert=lambda data, meta: convert_wsi_to_dicom(
            data, meta, ConvertOptions(device="cpu")),
        max_instances=2, cold_start=0.0, scale_down_delay=2.0, device="cpu",
    )
    psv = SyntheticScanner(seed=11).scan(512, 512, TILE)
    pipe.run_batch({"slides/circle.psv": psv}, timeout=240.0)
    sched.run(until=30.0)  # store ingest + subscriber fan-out
    (study,) = pipe.store_service.search_studies()
    pipe.request_export(study)
    sched.run(until=30.0)
    keys = pipe.derived.list()
    assert keys == [f"{study}/level_0.tiff", f"{study}/level_1.tiff"]

    # the exported level-0 TIFF goes back through the same sniffing
    # pipeline as any scanner upload and lands as a new study
    tif = pipe.derived.get(keys[0]).data
    out = pipe.run_batch({"slides/rescan.tiff": tif}, timeout=240.0)
    assert pipe.metrics.get("pipeline.format.tiff") >= 1
    levels = study_levels(out["slides/rescan.tiff"])
    assert sorted(k for k in levels if k.endswith(".dcm")) == \
        ["level_0.dcm", "level_1.dcm"]
    sched.run(until=30.0)
    assert len(pipe.store_service.search_studies()) == 2
    assert pipe.validator.quarantined == []
    sched.shutdown()


def test_exported_tiffs_byte_identical_to_repro(seed=7):
    """Same slide and pinned UIDs: both converters store the same study,
    and both export services write the same TIFF bytes (exact; slide
    content, F2)."""
    import repro.core as rcore
    import repro.wsi as rwsi
    from _torch_spine import pinned_convert

    psv = SyntheticScanner(seed=seed).scan(512, 512, TILE)
    meta = {"slide_id": f"exp{seed}", "format": "psv"}
    tar = pinned_convert(convert_wsi_to_dicom, ConvertOptions,
                         device="cpu")(psv, meta)
    assert tar == pinned_convert(rwsi.convert_wsi_to_dicom,
                                 rwsi.ConvertOptions)(psv, meta)

    sched = SimScheduler()
    store = ObjectStore(sched)
    svc = DicomStoreService(store.bucket("dicom"), sched)
    svc.store_study_archive("studies/exp.tar", tar)
    (study,) = svc.search_studies()
    ExportService(svc, store.bucket("derived"), device="cpu") \
        .export_study(study)

    rsched = rcore.SimScheduler()
    rstore = rcore.ObjectStore(rsched)
    rsvc = rwsi.DicomStoreService(rstore.bucket("dicom"), rsched)
    rsvc.store_study_archive("studies/exp.tar", tar)
    assert rsvc.search_studies() == [study]
    rwsi.ExportService(rsvc, rstore.bucket("derived")).export_study(study)

    ours = _derived_bytes(store.bucket("derived"))
    assert sorted(ours) == [f"{study}/level_0.tiff", f"{study}/level_1.tiff"]
    assert ours == _derived_bytes(rstore.bucket("derived"))
