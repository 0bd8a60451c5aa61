"""The paper's Figure-1 wiring: landing bucket → notification → pub/sub topic
→ push subscription → autoscaling conversion service → DICOM store →
downstream subscribers (validation, ML inference).

``ConversionPipeline`` assembles the microservices; the actual per-image work
is injected (`convert` callable for real execution, `service_time` model for
discrete-event simulation), so the same wiring backs:

* the real end-to-end example (synthetic slides through the port's converter
  on the card into DICOM Part-10 bytes in the DICOM-store bucket),
* the Figure 2/3 simulations at institutional scale,
* the fault-tolerance tests (killed workers, redelivery, idempotent writes).

In real mode (``convert`` supplied + ``RealScheduler``) the service executes
up to ``concurrency`` conversions per instance **in parallel** on the
scheduler's worker pool — the converter is thread-safe (each call keeps its
own side stream, pinned buffers and events; the kernels queue on each
thread's current stream) and its heavy host stages release the GIL — so a
multi-slide batch overlaps downloads, transform dispatches, and entropy
coding across slides, several conversions in flight on one card.

The Figure-1 final arrow is event-driven like the first one: the converted
study tar's ``OBJECT_FINALIZE`` in the dicom bucket pushes an ingest
subscription that unpacks the archive into the enterprise
``DicomStoreService`` (idempotent STOW under canonical instance keys),
whose own ``dicom-instance-stored`` topic fans out to the attached
validation and mock ML-inference subscribers.

The pipeline's third hop runs the other direction — retrieval: an
``export-request`` topic (its own push subscription + DLQ, symmetric with
ingestion) drives the ``ExportService``, which reads a stored study back
through QIDO/WADO and writes a deterministic tiled-TIFF pyramid into the
``derived`` bucket, where existing open-source analysis tooling (or this
very pipeline's TIFF sniffer, full circle) can consume it. Requests come
from ``request_export()`` or, with ``auto_export=True``, from every
``dicom-instance-stored`` event.

``device`` is where the read side decodes: the ML-inference subscriber and
the export service call ``decode_frames`` on it (``"cuda"`` by default; a
missing card raises when they first decode). The converter is the injected
``convert`` callable and picks its own device (``ConvertOptions.device``).
"""
from __future__ import annotations

import hashlib
import threading
from collections import Counter
from typing import Callable

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.analysis.racedep import tracked_state
from repro_torch.core import clock, tracing
from repro_torch.core.autoscaler import AutoscalingService
from repro_torch.core.fleet import ConverterFleet
from repro_torch.core.metrics import Metrics
from repro_torch.core.pubsub import DeliveryCtx, Message, Subscription, Topic
from repro_torch.core.storage import LifecycleRule, ObjectStore

__all__ = ["ConversionPipeline", "derive_out_key"]


def derive_out_key(key: str) -> str:
    """Landing key → DICOM-store study key, stripping only a trailing
    extension of the *basename* — dots in directory components
    (``scans.v1/slide``) and extensionless or dotfile basenames survive
    unmangled. Note ``a.svs`` and ``a.tiff`` still map to the same base
    key; ``ConversionPipeline._work`` disambiguates such collisions with a
    per-source suffix."""
    head, _, base = key.rpartition("/")
    stem = base.rsplit(".", 1)[0] or base
    return f"{head}/{stem}.dcm" if head else f"{stem}.dcm"


@tracked_state("converted", "_conversions", "_errors", "dead_lettered",
               "_out_claims", "export_dead_lettered")
class ConversionPipeline:
    def __init__(
        self,
        scheduler,
        *,
        convert: Callable[[bytes, dict], bytes] | None = None,
        service_time: Callable[[dict], float] | float = 60.0,
        max_instances: int = 100,
        min_instances: int = 0,
        concurrency: int = 1,
        cold_start: float = 10.0,
        scale_down_delay: float = 120.0,
        ack_deadline: float = 600.0,
        max_delivery_attempts: int = 5,
        min_backoff: float = 10.0,
        max_backoff: float = 600.0,
        hedge_after: float | None = None,
        landing_bucket: str = "wsi-landing",
        dicom_bucket: str = "dicom-store",
        instance_bucket: str = "dicom-instances",
        quarantine_bucket: str = "dicom-dlq",
        derived_bucket: str = "wsi-derived",
        subscribers: bool = True,
        auto_export: bool = False,
        lifecycle_cold_after: float = 30 * 24 * 3600.0,
        lifecycle_archive_after: float = 365 * 24 * 3600.0,
        fleet: dict | None = None,
        store_shards: int = 1,
        ordered_ingest: bool = False,
        delivery_faults=None,
        device: str = "cuda",
    ):
        self.scheduler = scheduler
        self.metrics = Metrics(scheduler)
        self.store = ObjectStore(scheduler, self.metrics)
        self.convert = convert
        self.service_time = service_time

        # --- storage & ingestion service --------------------------------
        self.landing = self.store.bucket(landing_bucket)
        self.dicom = self.store.bucket(dicom_bucket)
        self.landing.add_lifecycle_rule(
            LifecycleRule(lifecycle_cold_after, "COLDLINE"))
        self.landing.add_lifecycle_rule(
            LifecycleRule(lifecycle_archive_after, "ARCHIVE"))

        # --- pub/sub messaging service -----------------------------------
        self.topic = Topic("wsi-dicom-conversion", scheduler, self.metrics)
        self.dlq = Topic("wsi-dicom-conversion-dlq", scheduler, self.metrics)
        self.landing.add_notification(self.topic, "OBJECT_FINALIZE",
                                      ordered=ordered_ingest)

        # --- containerized conversion web application ---------------------
        # `fleet` switches the backend from the single AutoscalingService to
        # the multi-instance ConverterFleet (per-instance queues, controller
        # scaling, tenant fairness, load shedding); its dict carries the
        # fleet-only knobs (instance_queue_depth, tenant_quota, shed_*, ...)
        common = dict(
            max_instances=max_instances, min_instances=min_instances,
            concurrency=concurrency, cold_start=cold_start,
            scale_down_delay=scale_down_delay, metrics=self.metrics,
            real_work=convert is not None,
        )
        if fleet is not None:
            self.service = ConverterFleet(
                "wsi2dcm", scheduler, self._work,
                dlq_depth=lambda: len(self.dead_lettered),
                **common, **fleet)
        else:
            self.service = AutoscalingService(
                "wsi2dcm", scheduler, self._work, **common)
        self.subscription = Subscription(
            self.topic, "wsi2dcm-push", self._endpoint,
            ack_deadline=ack_deadline,
            max_delivery_attempts=max_delivery_attempts,
            min_backoff=min_backoff, max_backoff=max_backoff,
            hedge_after=hedge_after, dlq=self.dlq,
            faults=delivery_faults,
        )
        self.converted: list[str] = []
        self._conversions: list[tuple[str, str]] = []  # (source, out key)
        self._converted_lock = TrackedLock("ConversionPipeline._converted_lock")
        # wakes run_batch on every conversion or dead-letter (no busy-poll)
        self._batch_cond = threading.Condition(self._converted_lock)
        self._errors: dict[str, str] = {}  # source key -> last failure
        self.dead_lettered: list[tuple[dict, str]] = []  # (event, dlq_reason)
        # serializes out-key claims
        self._out_lock = TrackedLock("ConversionPipeline._out_lock")
        self._out_claims: dict[str, str] = {}  # out key -> source key
        # permanent-failure visibility: a sink on the conversion DLQ records
        # the poisoned event + reason so run_batch can fail fast instead of
        # spinning out its timeout
        self.dlq_sink = Subscription(self.dlq, "wsi2dcm-dlq-sink",
                                     self._dlq_endpoint)

        # --- enterprise DICOM store + downstream subscribers ----------------
        # (the Figure-1 final arrow, itself event-driven: study tar lands in
        # the dicom bucket → OBJECT_FINALIZE → ingest subscription → STOW →
        # instance-stored topic → validation / ML fan-out)
        from repro_torch.wsi.store_service import (DicomStoreService,
                                                   ShardedDicomStore)

        if store_shards > 1:
            # study-UID-hash sharding across bucket partitions; the shards
            # share one dicom-instance-stored topic so downstream
            # subscribers attach exactly as they do to a single store
            self.instances = None
            self.store_service = ShardedDicomStore(
                self.store, scheduler, self.metrics,
                n_shards=store_shards, bucket_prefix=instance_bucket)
        else:
            self.instances = self.store.bucket(instance_bucket)
            self.store_service = DicomStoreService(
                self.instances, scheduler, self.metrics)
        self.store_topic = Topic("dicom-study-finalize", scheduler,
                                 self.metrics)
        self.store_dlq = Topic("dicom-store-ingest-dlq", scheduler,
                               self.metrics)
        self.dicom.add_notification(self.store_topic, "OBJECT_FINALIZE")
        self.store_subscription = Subscription(
            self.store_topic, "dicom-store-ingest", self._store_endpoint,
            ack_deadline=ack_deadline,
            max_delivery_attempts=max_delivery_attempts, dlq=self.store_dlq,
        )
        self.validator = self.ml_subscriber = None
        if subscribers:
            from repro_torch.wsi.subscribers import (InferenceSubscriber,
                                                     ValidationService)

            self.quarantine = self.store.bucket(quarantine_bucket)
            self.validator = ValidationService(self.store_service,
                                               self.quarantine)
            self.ml_subscriber = InferenceSubscriber(self.store_service,
                                                     device=device)

        # --- export / retrieval hop (study → derived tiled-TIFF pyramid) ---
        # the third event-driven hop, symmetric with ingestion: its own
        # request topic, push subscription, and DLQ (with a sink recording
        # dead-lettered exports + the pipeline.export.dead_lettered metric)
        from repro_torch.wsi.export import ExportService

        self.derived = self.store.bucket(derived_bucket)
        self.export_topic = Topic("export-request", scheduler, self.metrics)
        self.export_dlq = Topic("export-request-dlq", scheduler,
                                self.metrics)
        self.export_service = ExportService(
            self.store_service, self.derived,
            request_topic=self.export_topic, dlq=self.export_dlq,
            ack_deadline=ack_deadline,
            max_delivery_attempts=max_delivery_attempts,
            min_backoff=min_backoff, max_backoff=max_backoff, device=device)
        self.export_dead_lettered: list[tuple[dict, str]] = []
        self.export_dlq_sink = Subscription(
            self.export_dlq, "dicom2tiff-dlq-sink", self._export_dlq_endpoint)
        self.auto_export_subscription = None
        if auto_export:
            self.auto_export_subscription = Subscription(
                self.store_service.topic, "auto-export-trigger",
                self._auto_export_endpoint)

    # ---- subscription push endpoint → service --------------------------
    def _endpoint(self, msg: Message, ctx: DeliveryCtx):
        def done(ok):
            if ok is True:
                ctx.ack()
                return
            if ok == "shed":
                # backpressure, not failure: a budget-exempt nack requeues
                # after min_backoff without consuming a delivery attempt,
                # so shed work can never dead-letter
                ctx.nack("load shed: converter fleet at capacity",
                         consume_budget=False)
                return
            with self._converted_lock:
                reason = self._errors.get(msg.data.get("name"),
                                          "conversion failed")
            ctx.nack(reason)

        self.service.receive(msg.data, done)

    # ---- conversion DLQ sink ---------------------------------------------
    def _dlq_endpoint(self, msg: Message, ctx: DeliveryCtx):
        with self._batch_cond:
            self.dead_lettered.append(
                (msg.data, msg.attributes.get("dlq_reason", "")))
            # the failure is now settled: drop the recorded error so a
            # later re-ingest of the same key can't report a stale reason
            self._errors.pop(msg.data.get("name"), None)
            self._batch_cond.notify_all()
        ctx.ack()

    # ---- export hop -----------------------------------------------------
    def request_export(self, study_uid: str) -> Message:
        """Ask the export service for a derived tiled-TIFF pyramid."""
        return self.export_topic.publish({"study_uid": study_uid})

    def _auto_export_endpoint(self, msg: Message, ctx: DeliveryCtx):
        # every stored instance re-requests its study's export; the export
        # is deterministic and the derived bucket content-addressed, so the
        # extra requests collapse into idempotent no-ops
        self.request_export(msg.data["study_uid"])
        ctx.ack()

    def _export_dlq_endpoint(self, msg: Message, ctx: DeliveryCtx):
        with self._converted_lock:
            self.export_dead_lettered.append(
                (msg.data, msg.attributes.get("dlq_reason", "")))
        self.metrics.inc("pipeline.export.dead_lettered")
        ctx.ack()

    # ---- dicom bucket → enterprise store ingest -------------------------
    def _store_endpoint(self, msg: Message, ctx: DeliveryCtx):
        try:
            archive = self.dicom.get(msg.data["name"]).data
            self.store_service.store_study_archive(msg.data["name"], archive)
        except Exception as exc:  # corrupt archive / racing delete → DLQ path
            ctx.nack(f"store ingest failed: {exc}")
        else:
            ctx.ack()

    # ---- the worker ------------------------------------------------------
    def _store_study(self, source_key: str, generation: str,
                     dcm_bytes: bytes) -> str:
        """Write a converted study under a collision-safe output key.

        The base key strips only the basename's trailing extension
        (``derive_out_key``), so distinct sources that share a stem
        (``a.svs`` vs ``a.tiff``) contend for the same base key. The first
        source keeps it; any other source gets a stable per-source suffix.
        A redelivered or re-uploaded source always maps back to its own
        key (idempotent re-conversion), never onto another source's study.
        Claims are recorded in an in-memory map under a short lock — only
        the decision is serialized; the (expensive, content-hashing,
        notification-fanning) bucket put runs outside it.
        """
        base = out_key = derive_out_key(source_key)
        with self._out_lock:
            owner = self._out_claims.get(base)
            if owner is None and self.dicom.exists(base):
                # pre-existing study from before this process claimed it
                owner = self.dicom.get(base).metadata.get("source_key")
            if owner not in (None, source_key):
                self.metrics.inc("pipeline.out_key_collisions")
                digest = hashlib.sha256(source_key.encode()).hexdigest()[:8]
                out_key = f"{base[:-len('.dcm')]}-{digest}.dcm"
            self._out_claims[out_key] = source_key
        self.dicom.put(out_key, dcm_bytes,
                       metadata={"source_generation": generation,
                                 "source_key": source_key})
        return out_key

    def _work(self, event: dict):
        if self.convert is None:  # simulation: return the service time
            st = self.service_time
            return st(event) if callable(st) else float(st)
        # real mode: download → sniff → convert → upload (idempotent,
        # content-addressed). One deployment serves a mixed landing bucket:
        # the container format is resolved from the object's magic bytes
        # (never the key), so .psv/.tiff/.svs slides all route through the
        # same converter; unknown containers fail with the actionable sniff
        # error, which becomes the nack reason and, after the retry budget,
        # the dead-letter's dlq_reason.
        # imported lazily (like the store service) so simulation-only use of
        # repro_torch.core never pays the repro_torch.wsi/torch import
        from repro_torch.wsi.formats import sniff

        try:
            with tracing.span("pipeline.fetch", key=event["name"]):
                obj = self.landing.get(event["name"])
                fmt = sniff(obj.data)
            self.metrics.inc(f"pipeline.format.{fmt}")
            meta = dict(obj.metadata)
            meta.setdefault("format", fmt)
            with tracing.span("pipeline.convert", key=event["name"],
                              format=fmt):
                dcm_bytes = self.convert(obj.data, meta)
        except Exception as exc:
            with self._converted_lock:
                self._errors[event["name"]] = \
                    f"{type(exc).__name__}: {exc}"
            raise
        with tracing.span("pipeline.store", key=event["name"]):
            out_key = self._store_study(event["name"], obj.generation,
                                        dcm_bytes)
        with self._batch_cond:
            self._errors.pop(event["name"], None)
            self.converted.append(out_key)
            self._conversions.append((event["name"], out_key))
            self._batch_cond.notify_all()
        return None

    # ---- ingestion --------------------------------------------------------
    def ingest(self, key: str, data: bytes, metadata: dict | None = None):
        """A scanner drops a slide into the landing zone."""
        return self.landing.put(key, data, metadata)

    def run_batch(self, slides: dict[str, bytes],
                  metadata: dict[str, dict] | None = None, *,
                  timeout: float = 600.0) -> dict[str, bytes]:
        """Real-mode batch driver: ingest every slide, wait for the studies.

        Blocks (wall clock — use with ``RealScheduler``) until every
        slide's study tar is durably in the DICOM store, then returns
        ``{landing key: study tar bytes}``. Completion is judged by
        *successful* conversions recorded per source key
        (``self._conversions``), not the service's completion metric,
        which also counts failed attempts that the subscription will
        still redeliver. The wait is a condition variable signalled by
        every finished conversion and every dead-letter — no busy-poll.

        Fails fast on permanent failures: the moment a batch slide is
        dead-lettered (retry budget exhausted), raises ``RuntimeError``
        carrying the ``dlq_reason`` instead of spinning out the timeout.
        Raises ``ValueError`` up front if two batch inputs derive the
        same output key (``a.svs`` + ``a.tiff``), and ``TimeoutError``
        if the batch does not finish within ``timeout`` seconds.
        """
        dupes = sorted(k for k, n in
                       Counter(map(derive_out_key, slides)).items() if n > 1)
        if dupes:
            raise ValueError(
                "batch inputs collide on output keys "
                f"{dupes} — rename the conflicting slides")
        # only conversions / dead-letters recorded after this call started
        # count, so a reused pipeline can't satisfy a new batch with stale
        # studies (or fail it on an old batch's poison slide)
        with self._converted_lock:
            start = len(self._conversions)
            dead_start = len(self.dead_lettered)
        for key, data in slides.items():
            meta = (metadata or {}).get(key, {"slide_id": key})
            self.ingest(key, data, meta)
        deadline = clock.monotonic() + timeout
        with self._batch_cond:
            while True:
                done = dict(self._conversions[start:])
                if all(k in done for k in slides):
                    break
                for event, reason in self.dead_lettered[dead_start:]:
                    if event.get("name") in slides:
                        raise RuntimeError(
                            f"slide {event['name']!r} dead-lettered: "
                            f"{reason}")
                remaining = deadline - clock.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"batch conversion incomplete after {timeout}s "
                        f"({len(set(done) & set(slides))}/{len(slides)} "
                        "studies stored)")
                self._batch_cond.wait(timeout=remaining)
        return {k: self.dicom.get(done[k]).data for k in slides}

    # ---- reporting -------------------------------------------------------
    def instance_series(self):
        return self.metrics.timeseries("svc.wsi2dcm.instances")

    def done_count(self) -> int:
        return int(self.metrics.get("svc.wsi2dcm.completed"))
