"""Downstream consumers of the DICOM store's instance-stored topic.

The paper's extensibility claim is that new services attach to existing
pub/sub topics without touching ingestion. These two subscribers are that
claim made concrete — both hang off ``DicomStoreService.topic``
(``dicom-instance-stored``) and never talk to the conversion service:

* :class:`ValidationService` — the community-validation workflow (cf.
  Silva et al.'s DICOM validation service): re-reads every stored blob,
  runs the :class:`~repro_torch.wsi.dicom.Part10Index` structural scan plus
  ``verify()`` deep checks, and **quarantines** corrupt instances — blob
  copied into a DLQ bucket with the failure reason, instance deleted from
  the store so QIDO/WADO stop serving it.
* :class:`InferenceSubscriber` — a mock ML model (cf. the Slim viewer's
  model integrations): pulls frames through frame-level WADO
  (``retrieve_frame`` off the cached index — no full-file reparse),
  **decodes** them to pixels on ``device`` (``decode_frames``: one
  ``entropy_decode`` and one ``jpeg_inverse`` launch per instance on
  ``"cuda"``, the default) and records per-frame pixel statistics,
  standing in for patch-level inference over the pyramid.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.core import tracing
from repro_torch.core.pubsub import DeliveryCtx, Message, Subscription
from repro_torch.core.storage import Bucket
from repro_torch.wsi.dicom import Part10Index
from repro_torch.wsi.jpeg import decode_frames
from repro_torch.wsi.store_service import DicomStoreService

__all__ = ["ValidationService", "InferenceSubscriber"]


class ValidationService:
    """Integrity-checks every stored instance; quarantines corrupt ones."""

    def __init__(self, store: DicomStoreService, quarantine_bucket: Bucket,
                 *, name: str = "dicom-validation"):
        self.store = store
        self.quarantine_bucket = quarantine_bucket
        self.metrics = store.metrics
        self._lock = TrackedLock("ValidationService._lock")
        self.checked: list[str] = []
        self.quarantined: list[tuple[str, str]] = []  # (sop_uid, reason)
        self.subscription = Subscription(store.topic, name, self._handle)

    def _handle(self, msg: Message, ctx: DeliveryCtx):
        sop = msg.data["sop_instance_uid"]
        try:
            blob = self.store.read_blob(msg.data["key"])
        except KeyError:
            ctx.ack()  # already deleted/quarantined — nothing to validate
            return
        try:
            Part10Index(blob).verify()
        except ValueError as exc:
            self._quarantine(sop, blob, str(exc))
        else:
            with self._lock:
                self.checked.append(sop)
            self.metrics.inc("validation.passed")
            # per-instance verify outcome as a structured span event on the
            # ambient delivery span (quarantines annotate in _quarantine)
            tracing.add_event(None, "validate.instance", sop=sop,
                              verdict="passed")
        ctx.ack()

    def _quarantine(self, sop: str, blob: bytes, reason: str):
        self.quarantine_bucket.put(f"quarantine/{sop}.dcm", blob,
                                   {"reason": reason})
        try:
            self.store.delete_instance(sop)
        except KeyError:
            pass  # concurrently deleted
        with self._lock:
            self.quarantined.append((sop, reason))
        self.metrics.inc("validation.quarantined")
        tracing.add_event(None, "validate.instance", sop=sop,
                          verdict="quarantined", reason=reason)

    def sweep(self) -> int:
        """Re-validate every indexed instance (bit-rot patrol, cron-style).

        Event delivery catches corruption present at store time; the sweep
        catches blobs that rotted afterwards. Returns the number
        quarantined.
        """
        before = len(self.quarantined)
        for study in self.store.search_studies():
            for meta in self.store.search_instances(study):
                try:
                    blob = self.store.read_blob(meta["key"])
                    Part10Index(blob).verify()
                except KeyError:
                    continue
                except ValueError as exc:
                    self._quarantine(meta["sop_instance_uid"], blob,
                                     str(exc))
        return len(self.quarantined) - before


class InferenceSubscriber:
    """Mock ML model: frame-level WADO fetches + decoded per-frame stats."""

    def __init__(self, store: DicomStoreService, *,
                 name: str = "ml-inference", max_frames: int = 4,
                 device="cuda"):
        self.store = store
        self.device = device
        self.metrics = store.metrics
        self.max_frames = max_frames
        self._lock = TrackedLock("InferenceSubscriber._lock")
        self.predictions: dict[str, dict] = {}  # sop_uid -> result
        self.subscription = Subscription(store.topic, name, self._handle)

    @staticmethod
    def frame_stats(pixels: np.ndarray) -> dict:
        """The stand-in embedding: decoded-pixel statistics of one frame."""
        f = pixels.astype(np.float64)
        return {"mean": float(f.mean()), "std": float(f.std()),
                "min": int(pixels.min()), "max": int(pixels.max())}

    def _handle(self, msg: Message, ctx: DeliveryCtx):
        sop = msg.data["sop_instance_uid"]
        try:
            # clamp to the *indexed* frame count, not the declared one — an
            # instance over-declaring (0028,0008) must not burn redeliveries
            idx = self.store.frame_index(sop)
            n = min(idx.n_frames, self.max_frames)
            frames = [self.store.retrieve_frame(sop, i) for i in range(n)]
            # the shared store-consumer dispatch: JPEG frames decode as one
            # batch on the device, native frames are reshaped on the host
            pixels = decode_frames(
                frames, transfer_syntax=msg.data.get("transfer_syntax"),
                rows=msg.data.get("rows") or 0,
                cols=msg.data.get("columns") or 0, device=self.device)
            stats = [self.frame_stats(pixels[i]) for i in range(n)]
        except (KeyError, ValueError):
            # quarantined/deleted before we ran, rotted since storing, or
            # undecodable ("corrupt JPEG …") — the validation subscriber
            # owns that path; nothing to score
            ctx.ack()
            return
        with self._lock:
            self.predictions[sop] = {
                "study_uid": msg.data["study_uid"],
                "frames_scored": n,
                "pixel_stats": stats,
            }
        self.metrics.inc("inference.instances")
        self.metrics.inc("inference.frames", n)
        self.metrics.inc("inference.pixels",
                         int(np.prod(pixels.shape[:3])) if n else 0)
        tracing.add_event(None, "inference.instance", sop=sop, frames=n)
        ctx.ack()
