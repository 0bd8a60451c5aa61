"""End-to-end on the port: scanner → landing bucket → event → autoscaled
conversion → DICOM store → validation/ML subscribers; crash/resume,
effectively-once under redelivery, collision-safe output keys; the paper's
Figure 2/3 claims over the port's pipeline; and study tars byte-identical
to ``repro``'s pipeline on the same pinned-UID slides.

The port's copy of ``tests/test_wsi_pipeline.py`` and
``tests/test_paper_claims.py``, on the CPU (``device="cpu"``). Where the ML
subscriber decodes, slides use 64-px tiles (the reference: 256), since the
CPU's plain entropy decode steps once per symbol of the longest tile. The
Figure 2/3 model is the port's ``repro_torch.core.workflows``, and the
warm-instance Figure 2 case runs its
``SimScheduler`` to a stated horizon, since a warm instance never lets the
heap drain.
"""
import pytest

from _torch_spine import (pinned_convert, port_lockdep_armed,  # noqa: F401
                          port_racedep_armed)
from repro_torch.core import ConversionPipeline, RealScheduler, SimScheduler
from repro_torch.core import clock
from repro_torch.core.clock import wall_sleep
from repro_torch.core.pipeline import derive_out_key
from repro_torch.core.workflows import (autoscaling_time, fig3_run,
                                        parallel_time, serial_time)
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom, read_part10, sniff,
                             study_levels)

TILE = 64


def _convert_cpu(data, meta):
    return convert_wsi_to_dicom(data, meta, ConvertOptions(device="cpu"))


def test_simulated_batch_conversion_completes():
    sched = SimScheduler()
    pipe = ConversionPipeline(sched, service_time=60.0, cold_start=10.0,
                              max_instances=25)
    for i in range(25):
        pipe.ingest(f"slides/s{i}.psv", b"x" * (i + 1))
    sched.run()
    assert pipe.done_count() == 25
    assert pipe.service.instance_count() == 0  # back to zero


def test_real_mode_end_to_end_conversion():
    """RealScheduler + the port's converter on small synthetic slides."""
    sched = RealScheduler(workers=4)
    pipe = ConversionPipeline(
        sched, convert=_convert_cpu, max_instances=2, cold_start=0.0,
        scale_down_delay=2.0, device="cpu",
    )
    scanner = SyntheticScanner(seed=5)
    for i in range(2):
        pipe.ingest(f"slides/s{i}.psv", scanner.scan(256, 256, TILE),
                    {"slide_id": f"S{i}"})
    sched.run(until=240.0)  # returns once quiescent
    assert pipe.done_count() == 2
    keys = pipe.dicom.list()
    assert sorted(keys) == ["slides/s0.dcm", "slides/s1.dcm"]
    study = study_levels(pipe.dicom.get("slides/s0.dcm").data)
    ds, frames = read_part10(study["level_0.dcm"])
    assert ds.get_int(0x0028, 0x0008) == 16  # 256² slide = 4×4 tile frames
    sched.shutdown()


def test_crash_resume_skips_finished_levels():
    psv = SyntheticScanner(seed=2).scan(512, 512, 256)
    opt = ConvertOptions(device="cpu")
    convert_wsi_to_dicom(psv, options=opt)  # "crashed after" full run
    done_levels = dict(opt.manifest)
    opt2 = ConvertOptions(manifest=done_levels, device="cpu")
    out2 = convert_wsi_to_dicom(psv, options=opt2)
    # resumed conversion reuses every finished level byte-for-byte
    lv = study_levels(out2)
    for k, blob in lv.items():
        if k.endswith(".dcm"):
            idx = k.split("_")[1].split(".")[0]
            assert blob == done_levels[idx]


def test_derive_out_key_strips_only_trailing_basename_extension():
    assert derive_out_key("slides/a.svs") == "slides/a.dcm"
    assert derive_out_key("a.tiff") == "a.dcm"
    assert derive_out_key("scans.v1/slide") == "scans.v1/slide.dcm"
    assert derive_out_key("scans.v1/slide.svs") == "scans.v1/slide.dcm"
    assert derive_out_key("slide") == "slide.dcm"
    assert derive_out_key(".hidden") == ".hidden.dcm"
    assert derive_out_key("a/b.c/x.y.svs") == "a/b.c/x.y.dcm"


def test_colliding_sources_get_distinct_out_keys_and_reach_the_store():
    """a.svs and a.tiff do not overwrite each other's study, a dotted
    directory survives, and every study flows on into the DICOM store
    subsystem with both subscribers running (the Figure-1 final arrow)."""
    sched = RealScheduler(workers=4)
    pipe = ConversionPipeline(
        sched, convert=_convert_cpu, max_instances=2, cold_start=0.0,
        scale_down_delay=2.0, device="cpu",
    )
    scanner = SyntheticScanner(seed=13)
    slides = {"slides/a.svs": scanner.scan(256, 256, TILE),
              "slides/a.tiff": scanner.scan(512, 256, TILE),
              "scans.v1/slide": scanner.scan(256, 256, TILE)}
    # colliding keys arrive as separate uploads (run_batch would refuse the
    # pair up front), so ingest directly and wait for the conversions
    for key, data in slides.items():
        pipe.ingest(key, data, {"slide_id": key})
    deadline = clock.monotonic() + 240.0
    while clock.monotonic() < deadline:
        with pipe._converted_lock:
            done = dict(pipe._conversions)
        if len(done) == 3:
            break
        wall_sleep(0.01)
    outs = {k: pipe.dicom.get(v).data for k, v in done.items()}

    keys = pipe.dicom.list()
    assert "slides/a.dcm" in keys and "scans.v1/slide.dcm" in keys
    assert len(keys) == 3  # the second "a" got a suffixed key, not a merge
    assert pipe.metrics.get("pipeline.out_key_collisions") == 1
    # each source's study survives as its own conversion (distinct UIDs)
    assert study_levels(outs["slides/a.tiff"])["study.json"] \
        != study_levels(outs["slides/a.svs"])["study.json"]

    # the store subsystem ingested every study and fanned out to subscribers
    deadline = clock.monotonic() + 60.0
    while len(pipe.store_service.search_studies()) < 3 \
            and clock.monotonic() < deadline:
        wall_sleep(0.01)
    studies = pipe.store_service.search_studies()
    assert len(studies) == 3
    deadline = clock.monotonic() + 60.0
    while (len(pipe.validator.checked) < 3
           or len(pipe.ml_subscriber.predictions) < 3) \
            and clock.monotonic() < deadline:
        wall_sleep(0.01)
    assert len(pipe.validator.checked) == 3
    assert pipe.validator.quarantined == []
    assert len(pipe.ml_subscriber.predictions) == 3
    sched.shutdown()


def test_redelivered_source_reuses_its_out_key():
    """A redelivered/re-uploaded source maps back to its own key — the
    collision suffix never applies to the same landing key."""
    sched = RealScheduler(workers=4)
    pipe = ConversionPipeline(
        sched, convert=_convert_cpu, max_instances=2, cold_start=0.0,
        scale_down_delay=2.0, subscribers=False, device="cpu",
    )
    psv = SyntheticScanner(seed=17).scan(256, 256, 256)
    pipe.run_batch({"slides/r.svs": psv}, timeout=240.0)
    # same key, new content (re-scan): replaces, no suffixed sibling
    psv2 = SyntheticScanner(seed=18).scan(256, 256, 256)
    pipe.run_batch({"slides/r.svs": psv2}, timeout=240.0)
    assert pipe.dicom.list() == ["slides/r.dcm"]
    assert pipe.metrics.get("pipeline.out_key_collisions", 0) == 0
    sched.shutdown()


def test_run_batch_fails_fast_on_poison_slide():
    """A slide that permanently fails conversion raises with the
    dlq_reason as soon as the retry budget is exhausted."""
    sched = RealScheduler(workers=4)

    def convert(data, meta):
        if "bad" in meta["slide_id"]:
            raise ValueError("unreadable slide: vendor firmware glitch")
        return _convert_cpu(data, meta)

    pipe = ConversionPipeline(
        sched, convert=convert, max_instances=2, cold_start=0.0,
        scale_down_delay=2.0, max_delivery_attempts=2,
        min_backoff=0.05, max_backoff=0.05, subscribers=False,
        device="cpu",
    )
    scanner = SyntheticScanner(seed=3)
    slides = {"slides/ok.psv": scanner.scan(256, 256, 256),
              "slides/bad.psv": scanner.scan(256, 256, 256)}
    t0 = clock.monotonic()
    with pytest.raises(RuntimeError,
                       match="slides/bad.psv.*unreadable slide"):
        pipe.run_batch(slides, timeout=240.0)
    assert clock.monotonic() - t0 < 60.0  # failed fast, not at the timeout
    assert any("vendor firmware glitch" in reason
               for _, reason in pipe.dead_lettered)
    sched.shutdown()


def test_run_batch_raises_on_duplicate_out_keys():
    sched = RealScheduler(workers=2)
    pipe = ConversionPipeline(
        sched, convert=lambda data, meta: b"", max_instances=1,
        cold_start=0.0, scale_down_delay=2.0,
    )
    with pytest.raises(ValueError, match="collide.*a.dcm"):
        pipe.run_batch({"a.svs": b"x", "a.tiff": b"y"})
    assert pipe.landing.list() == []  # rejected before any ingest
    sched.shutdown()


def test_redelivered_conversion_is_effectively_once():
    """Kill the worker mid-conversion → redelivery converts exactly once."""
    sched = SimScheduler()
    pipe = ConversionPipeline(sched, service_time=100.0, cold_start=0.0,
                              ack_deadline=150.0, max_instances=4)
    pipe.ingest("slides/a.psv", b"payload")
    sched.run(until=50.0)  # conversion in flight
    pipe.service.kill_instance()
    sched.run()
    assert pipe.done_count() == 1
    assert pipe.metrics.get("sub.wsi2dcm-push.deadline_expired") >= 1


def test_missing_card_raises_not_falls_back(monkeypatch):
    """The read side defaults to the card: without one, the inference hop
    fails (and retries) instead of decoding on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.wsi.subscribers import InferenceSubscriber

    sched = SimScheduler()
    pipe = ConversionPipeline(sched, max_delivery_attempts=1,
                              min_backoff=0.1, max_backoff=0.1)
    assert isinstance(pipe.ml_subscriber, InferenceSubscriber)
    assert pipe.ml_subscriber.device == "cuda"
    assert pipe.export_service.device == "cuda"
    tar = _convert_cpu(SyntheticScanner(seed=4).scan(128, 128, TILE),
                       {"slide_id": "s"})
    pipe.dicom.put("studies/s.dcm", tar)
    sched.run()
    assert pipe.ml_subscriber.predictions == {}
    assert pipe.metrics.get("sub.ml-inference.acks", 0) == 0


# ---------------------------------------------------------- paper claims
def test_fig2_cold_start_loses_at_one_image():
    tau = 90.0
    assert autoscaling_time(1, tau) > serial_time(1, tau)
    assert autoscaling_time(1, tau) > parallel_time(1, tau)


def test_fig2_autoscaling_wins_at_batch_sizes():
    tau = 90.0
    for n in (10, 25, 50):
        a = autoscaling_time(n, tau)
        p = parallel_time(n, tau)
        s = serial_time(n, tau)
        assert a < p < s, (n, a, p, s)


def test_fig2_autoscaling_is_flat_in_batch_size():
    """The paper's plateau: once hot, completion time ~independent of n."""
    tau = 90.0
    times = [autoscaling_time(n, tau) for n in (10, 25, 50)]
    assert max(times) - min(times) < 0.05 * min(times)


#: simulated seconds the warm-instance case runs: the one image finishes
#: at ~102 s; the reference runs to ``max_events`` instead
WARM_HORIZON = 3600.0


def test_fig2_cold_start_tradeoff_with_warm_instances():
    """Paper §Limitations: min_instances removes the cold start but costs
    idle capacity — quantified."""
    def one_image_latency(min_instances):
        sched = SimScheduler()
        pipe = ConversionPipeline(sched, service_time=90.0, cold_start=12.0,
                                  min_instances=min_instances)
        pipe.ingest("s.psv", b"x")
        sched.run(until=WARM_HORIZON)
        assert pipe.done_count() == 1
        lat = pipe.metrics.timeseries("svc.wsi2dcm.latency")
        return lat[-1][1]

    assert one_image_latency(0) - one_image_latency(1) >= 11.0


def test_fig3_ramp_plateau_decay():
    minutes, pipe = fig3_run(n=50, tau=90.0)
    values = [v for _, v in minutes]
    assert max(values) >= 45  # ramp to ~one instance per slide
    assert values[-1] == 0  # decay to zero (no idle cost)
    assert pipe.done_count() == 50
    assert pipe.service.cold_starts == 50


# ------------------------------------------------ parity with repro (exact)
def _parity_slides():
    scanner = SyntheticScanner(seed=31)
    return {"scans/p0.psv": scanner.scan(512, 512, 256),
            "scans/p1.svs": scanner.scan_tiff(512, 256, 256),
            "scans/p2.psv": scanner.scan(256, 512, 256)}


def _pipeline_tars(core, convert, slides, **kw):
    sched = core.SimScheduler()
    pipe = core.ConversionPipeline(sched, convert=convert, cold_start=1.0,
                                   max_instances=2, subscribers=False, **kw)
    for k, d in slides.items():
        pipe.ingest(k, d, {"slide_id": k})
    sched.run()
    assert pipe.dead_lettered == []
    store = pipe.store_service
    stored = {u: [(m["sop_instance_uid"], m["generation"])
                  for m in store.search_instances(u)]
              for u in store.search_studies()}
    return {k: pipe.dicom.get(derive_out_key(k)).data for k in slides}, \
        stored


@pytest.mark.parametrize("store_shards,ordered_ingest",
                         [(1, False), (2, True)])
def test_pipeline_tars_byte_identical_to_repro(store_shards, ordered_ingest):
    """Same slides (PSV and TIFF), same pinned UIDs, same wiring: the
    port's pipeline stores the same study tars as ``repro``'s, and its
    DICOM store serves the same instances (exact)."""
    import repro.core as rcore
    import repro.wsi as rwsi
    import repro_torch.core as tcore

    slides = _parity_slides()
    assert [sniff(d) for d in slides.values()] == ["psv", "tiff", "psv"]
    kw = dict(store_shards=store_shards, ordered_ingest=ordered_ingest)
    ours, our_store = _pipeline_tars(
        tcore, pinned_convert(convert_wsi_to_dicom, ConvertOptions,
                              device="cpu"), slides, device="cpu", **kw)
    theirs, their_store = _pipeline_tars(
        rcore, pinned_convert(rwsi.convert_wsi_to_dicom,
                              rwsi.ConvertOptions), slides, **kw)
    assert ours == theirs
    assert our_store == their_store and len(our_store) == len(slides)


def test_concurrent_conversions_equal_serial():
    """Real threads, several conversions in flight: every tar equals the
    serial conversion of the same slide with the same UIDs (exact)."""
    slides = _parity_slides()
    convert = pinned_convert(convert_wsi_to_dicom, ConvertOptions,
                             device="cpu")
    serial = {k: convert(d, {"slide_id": k}) for k, d in slides.items()}
    sched = RealScheduler(workers=8)
    try:
        pipe = ConversionPipeline(
            sched, convert=convert, max_instances=2, concurrency=2,
            cold_start=0.0, fleet={}, store_shards=2, subscribers=False,
            device="cpu")
        out = pipe.run_batch(slides, {k: {"slide_id": k} for k in slides},
                             timeout=240.0)
    finally:
        sched.shutdown()
    assert out == serial
