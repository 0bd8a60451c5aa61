"""Event-driven DICOM → tiled-TIFF export — ingestion's mirror image.

The paper's interoperability claim runs both directions: slides must get
*into* the archive from any scanner container, and *out* of it into the
containers existing open-source analysis tools consume (cf. ``dicom2tiff``;
tiled TIFF is what the downstream ecosystem reads). This service is the
pipeline's third event-driven hop, symmetric with ingestion:

    export-request topic ──push──▶ ExportService ──▶ derived bucket
        ▲      (at-least-once, retries, its own DLQ)     (tiled TIFFs)
        │
        ├── ConversionPipeline.request_export(study_uid)   (explicit)
        └── dicom-instance-stored ─▶ auto-export trigger   (optional)

Per request, the whole study is read back through the store's own public
retrieval surface — QIDO (``search_instances``) for the level inventory,
frame-level WADO (``retrieve_frame`` off the cached
:class:`~repro_torch.wsi.dicom.Part10Index`) for the tile bytes — so the export
path exercises exactly what an external DICOMweb consumer would. Each
level's frames are decoded with the batched inverse path
(``decode_tiles_batch``: one vectorized entropy-decode pass + one fused
``jpeg_inverse`` dispatch per level) and rewritten as one classic tiled
TIFF per level in the ``derived`` bucket.

**Determinism invariant** (asserted in tests and ``export_bench``): the
decoded pixels, the Aperio-style ``ImageDescription`` provenance, and the
``write_tiff`` serialization are all deterministic, so exporting the same
study twice — including after a store crash + ``rebuild_index()`` — yields
**byte-identical** TIFFs. Determinism is also what makes re-exports cheap:
a level whose derived TIFF already records the instance's content
generation is skipped outright by default (no WADO fetch, no decode), and
even a forced re-derivation lands as a content-addressed bucket no-op.
The exported TIFF reopens through the
``TiffSlideReader`` sniffer, closing the loop: a study can round-trip
store → TIFF → (re-ingest) → store with no manual format plumbing.

**Failure semantics**: a corrupt stored frame surfaces as the decoder's
actionable ``ValueError("corrupt JPEG …")``; the handler nacks with that
reason, so after the retry budget it becomes the dead-letter's
``dlq_reason`` — the same observability contract as the ingestion hop.
"""
from __future__ import annotations

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.core import tracing
from repro_torch.core.pubsub import DeliveryCtx, Message, Subscription, Topic
from repro_torch.core.storage import Bucket
from repro_torch.wsi.formats import write_tiff
from repro_torch.wsi.jpeg import decode_frames
from repro_torch.wsi.store_service import DicomStoreService

__all__ = ["ExportService"]


class ExportService:
    """Turns stored DICOM studies back into tiled-TIFF pyramids.

    ``request_topic`` is the ``export-request`` topic; requests are
    ``{"study_uid": …}`` dicts. Pass ``request_topic=None`` to use the
    service as a plain library (direct ``export_study`` calls) without any
    subscription — benchmarks and tests do this.

    ``device`` is where each level's frames decode (``decode_frames``: one
    ``entropy_decode`` and one ``jpeg_inverse`` launch per level on
    ``"cuda"``, the default; ``"cpu"`` runs their plain versions). A CUDA
    device on a machine without one raises. The device never changes the
    exported bytes on slide content.
    """

    def __init__(self, store: DicomStoreService, derived: Bucket, *,
                 request_topic: Topic | None = None, dlq: Topic | None = None,
                 name: str = "dicom2tiff", ack_deadline: float = 600.0,
                 max_delivery_attempts: int = 5, min_backoff: float = 10.0,
                 max_backoff: float = 600.0, device="cuda"):
        self.store = store
        self.derived = derived
        self.device = device
        self.metrics = store.metrics
        self._lock = TrackedLock("ExportService._lock")
        self.exported: list[tuple[str, tuple[str, ...]]] = []
        self.subscription = None
        if request_topic is not None:
            self.subscription = Subscription(
                request_topic, name, self._handle,
                ack_deadline=ack_deadline,
                max_delivery_attempts=max_delivery_attempts,
                min_backoff=min_backoff, max_backoff=max_backoff, dlq=dlq)

    # ---- push endpoint ---------------------------------------------------
    def _handle(self, msg: Message, ctx: DeliveryCtx):
        study_uid = msg.data.get("study_uid")
        try:
            if not study_uid:
                raise KeyError("export request without study_uid")
            self.export_study(study_uid)
        except (KeyError, ValueError) as exc:
            # unknown study (racing delete) or corrupt stored frames — the
            # decoder's "corrupt JPEG …" string rides the nack so the
            # dead-letter carries an actionable dlq_reason
            ctx.nack(f"export failed: {exc}")
        else:
            ctx.ack()

    # ---- the export ------------------------------------------------------
    def export_study(self, study_uid: str, *,
                     skip_unchanged: bool = True) -> list[str]:
        """Export every level of a study; returns the derived-bucket keys.

        Deterministic: repeated exports (including after a store
        ``rebuild_index()``) write byte-identical TIFFs. By default a
        level whose derived TIFF already records the instance's content
        generation is skipped outright — no WADO fetch, no decode —
        which keeps the per-instance auto-export fan-out O(levels)
        instead of O(levels²); ``skip_unchanged=False`` forces the full
        re-derivation (the benchmark uses it to *prove* byte identity
        rather than assume it).
        """
        self.metrics.inc("pipeline.export.requests")
        with tracing.span("export.study", study=study_uid):
            metas = self.store.search_instances(study_uid)
            if not metas:
                raise KeyError(f"unknown study {study_uid}")
            keys = []
            for li, meta in enumerate(metas):
                key = self._export_level(study_uid, li, meta, skip_unchanged)
                if key is not None:
                    keys.append(key)
                    tracing.add_event(None, "export.level", key=key)
        with self._lock:
            self.exported.append((study_uid, tuple(keys)))
        return keys

    def _export_level(self, study_uid: str, li: int, meta: dict,
                      skip_unchanged: bool) -> str | None:
        """One WSM instance (one pyramid level) → one tiled TIFF."""
        sop = meta["sop_instance_uid"]
        level = li if meta["instance_number"] is None \
            else meta["instance_number"] - 1
        key = f"{study_uid}/level_{level}.tiff"
        if skip_unchanged and self.derived.exists(key) and \
                self.derived.get(key).metadata.get("source_generation") \
                == meta["generation"]:
            # the derived TIFF already reflects these instance bytes and
            # the export is deterministic — nothing to re-derive
            self.metrics.inc("pipeline.export.levels_unchanged")
            return key
        tile, cols = meta["rows"] or 0, meta["columns"] or 0
        total_rows, total_cols = meta["total_rows"] or 0, \
            meta["total_cols"] or 0
        n = self.store.frame_index(sop).n_frames
        if n == 0:
            # a level smaller than one tile stores no full frames — there
            # are no pixels to export (the converter's per-tile path agrees)
            self.metrics.inc("pipeline.export.levels_skipped")
            return None
        if tile <= 0 or tile != cols:
            raise ValueError(
                f"unsupported WSM instance {sop}: non-square "
                f"{tile}x{cols} tiles")
        bh, bw = total_rows // tile, total_cols // tile
        if bh * bw != n:
            raise ValueError(
                f"corrupt WSM instance {sop}: {n} frames for a "
                f"{bh}x{bw} tile grid")

        frames = [self.store.retrieve_frame(sop, i) for i in range(n)]
        try:
            rgb = decode_frames(frames,
                                transfer_syntax=meta["transfer_syntax"],
                                rows=tile, cols=tile, device=self.device)
        except ValueError as exc:
            raise ValueError(f"instance {sop}: {exc}") from None
        self.metrics.inc("pipeline.export.frames_decoded", n)

        tiles = {(r, c): rgb[r * bw + c]
                 for r in range(bh) for c in range(bw)}
        desc = (f"repro-dicom2tiff|study = {study_uid}"
                f"|series = {meta['series_uid']}|sop = {sop}"
                f"|level = {level}|total_rows = {total_rows}"
                f"|total_cols = {total_cols}"
                f"|source_generation = {meta['generation']}")
        tif = write_tiff(tiles, bh * tile, bw * tile, tile, description=desc)
        self.derived.put(key, tif, metadata={
            "study_uid": study_uid, "sop_instance_uid": sop,
            "source_generation": meta["generation"]})
        self.metrics.inc("pipeline.export.bytes_written", len(tif))
        return key
