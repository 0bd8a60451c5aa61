"""Enterprise DICOM store — the final arrow of the paper's Figure 1.

A DICOMweb-shaped service over a bucket:

* **STOW** — instances land under canonical keys
  (``instances/{study}/{series}/{sop}.dcm``), so re-storing a SOP UID
  **replaces** its blob and index entry, never duplicates it: redelivered
  pub/sub messages (at-least-once) and re-uploaded study archives leave
  QIDO/WADO results byte-identical to a single clean store.
* **QIDO** — study/series/instance search with patient/modality/date
  filtering (a study matches if *any* of its instances does) plus study-
  and series-level aggregation, always in a stable sorted order regardless
  of instance arrival order.
* **WADO** — whole-instance retrieve, and frame-level retrieve served from
  a cached :class:`~repro_torch.wsi.dicom.Part10Index` so a single frame fetch
  costs O(frame), not a full Part-10 reparse.
* **Durability** — the metadata index is checkpointed into the bucket
  (``_meta/index.json``) and ``rebuild_index()`` reconstructs it after a
  crash from the checkpoint plus a blob rescan, so a restarted store serves
  identical QIDO/WADO results.

Every stored instance is published on the store's own
``dicom-instance-stored`` topic; downstream consumers (the paper's "ML
model subscriber", the validation/QA workflow — see
``repro_torch.wsi.subscribers``) attach there without touching ingestion,
demonstrating the extensibility claim.
"""
from __future__ import annotations

import hashlib
import json
from collections import OrderedDict

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.analysis.racedep import tracked_state
from repro_torch.core import tracing
from repro_torch.core.pubsub import Topic
from repro_torch.core.storage import Bucket
from repro_torch.wsi.convert import study_levels
from repro_torch.wsi.dicom import Part10Index

__all__ = ["DicomStoreService", "ShardedDicomStore"]


@tracked_state("_index", "_studies", "_frame_cache")
class DicomStoreService:
    #: bucket key of the persistent index checkpoint
    INDEX_KEY = "_meta/index.json"
    #: prefix under which instance blobs live (rescanned on rebuild)
    PREFIX = "instances/"
    #: retained Part10Index objects for frame-level WADO (LRU)
    FRAME_CACHE = 128

    def __init__(self, bucket: Bucket, scheduler, metrics=None, *,
                 topic: Topic | None = None):
        self.bucket = bucket
        self.scheduler = scheduler
        self.metrics = metrics or bucket.metrics
        # shards of a ShardedDicomStore share one instance-stored topic so
        # downstream subscribers attach once, not once per shard
        self.topic = topic if topic is not None else \
            Topic("dicom-instance-stored", scheduler, self.metrics)
        self._lock = TrackedLock("DicomStoreService._lock", reentrant=True)
        self._index: dict[str, dict] = {}  # sop_uid -> metadata
        self._studies: dict[str, list[str]] = {}  # study_uid -> [sop_uid]
        self._frame_cache: OrderedDict[str, tuple[str, Part10Index]] = \
            OrderedDict()  # sop_uid -> (generation, index)

    # ---- STOW ---------------------------------------------------------------
    def store_study_archive(self, key: str, archive: bytes) -> list[str]:
        """Ingest a converted study tar (one .dcm per pyramid level)."""
        with tracing.span("stow.archive", key=key):
            stored = []
            for name, blob in study_levels(archive).items():
                if not name.endswith(".dcm"):
                    continue
                stored.append(
                    self.store_instance(blob, source=f"{key}/{name}"))
            self.checkpoint()
        return stored

    def store_instance(self, part10: bytes, *, source: str | None = None,
                       _index: Part10Index | None = None) -> str:
        """Store one Part-10 instance; idempotent per SOP instance UID.

        The blob key is derived from the instance identity, so a re-store
        (redelivery, re-upload) replaces rather than duplicates. The
        instance-stored event is published only when the stored bytes are
        new or changed — identical redeliveries are silent. ``_index`` lets
        the sharded router pass its already-parsed structural scan through
        instead of re-parsing.
        """
        # raises ValueError on corrupt input
        idx = _index if _index is not None else Part10Index(part10)
        meta = self._meta_from_index(idx, source)
        sop, study = meta["sop_instance_uid"], meta["study_uid"]
        if not sop or not study:
            raise ValueError(
                "corrupt Part-10 stream: instance without SOP/study UID")
        key = f"{self.PREFIX}{study}/{meta['series_uid']}/{sop}.dcm"
        meta["key"] = key
        obj = self.bucket.put(key, part10, {"sop_instance_uid": sop})
        meta["generation"] = obj.generation
        with self._lock:
            prev = self._index.get(sop)
            if prev is not None and prev["key"] != key:
                # identity moved (study/series changed): drop the old blob
                self.bucket.delete(prev["key"])
                old = self._studies.get(prev["study_uid"], [])
                old[:] = [s for s in old if s != sop]
                if not old:  # no ghost studies in QIDO
                    self._studies.pop(prev["study_uid"], None)
            self._index[sop] = meta
            sops = self._studies.setdefault(study, [])
            if sop not in sops:
                sops.append(sop)
            self._frame_cache.pop(sop, None)
        if prev is None:
            self.metrics.inc("dicomstore.instances")
        else:
            self.metrics.inc("dicomstore.replaced")
        tracing.add_event(None, "stow.instance", sop=sop,
                          replaced=prev is not None)
        if prev is None or prev["generation"] != obj.generation:
            self.topic.publish(dict(meta))
        return sop

    @staticmethod
    def _meta_from_index(idx: Part10Index, source: str | None) -> dict:
        return {
            "sop_instance_uid": idx.get_str(0x0008, 0x0018),
            "sop_class_uid": idx.get_str(0x0008, 0x0016),
            "study_uid": idx.get_str(0x0020, 0x000D),
            "series_uid": idx.get_str(0x0020, 0x000E),
            "instance_number": idx.get_int(0x0020, 0x0013),
            "patient_id": idx.get_str(0x0010, 0x0020),
            "modality": idx.get_str(0x0008, 0x0060),
            "study_date": idx.get_str(0x0008, 0x0020),
            "rows": idx.get_int(0x0028, 0x0010),
            "columns": idx.get_int(0x0028, 0x0011),
            "frames": idx.get_int(0x0028, 0x0008),
            "total_rows": idx.get_int(0x0048, 0x0007),
            "total_cols": idx.get_int(0x0048, 0x0006),
            "transfer_syntax": idx.get_str(0x0002, 0x0010),
            "source": source,
        }

    def delete_instance(self, sop_instance_uid: str) -> dict:
        """Remove an instance (blob + index + cache); returns its metadata.

        This is the quarantine path: the validation subscriber copies the
        corrupt blob to its DLQ bucket first, then deletes it here so
        QIDO/WADO stop serving it.
        """
        with self._lock:
            meta = self._index.pop(sop_instance_uid, None)
            if meta is None:
                raise KeyError(f"unknown SOP instance {sop_instance_uid}")
            study = meta["study_uid"]
            sops = self._studies.get(study, [])
            sops[:] = [s for s in sops if s != sop_instance_uid]
            if not sops:
                self._studies.pop(study, None)
            self._frame_cache.pop(sop_instance_uid, None)
        self.bucket.delete(meta["key"])
        self.metrics.inc("dicomstore.deleted")
        return meta

    # ---- persistent index ----------------------------------------------------
    def checkpoint(self) -> None:
        """Write the metadata index into the bucket (crash-recovery point)."""
        with self._lock:
            # copy under the lock: serialization runs outside it, and a
            # concurrent STOW mutating the live dict would crash json.dumps
            snap = {"instances": dict(self._index)}
        self.bucket.put(self.INDEX_KEY,
                        json.dumps(snap, sort_keys=True).encode())
        self.metrics.inc("dicomstore.checkpoints")

    def rebuild_index(self) -> int:
        """Rebuild the in-memory index after a crash.

        Loads the last checkpoint, then rescans every blob under
        ``instances/`` — blobs missing from the checkpoint (or stored after
        it) are re-parsed with :class:`Part10Index` (header scan only, no
        frame materialization); checkpoint entries whose blob is gone are
        dropped. Returns the number of blobs that had to be re-parsed.
        Unparseable blobs are skipped and counted in
        ``dicomstore.rebuild_skipped`` (the validation subscriber is the
        quarantine path for those).
        """
        try:
            snap = json.loads(self.bucket.get(self.INDEX_KEY).data)
        except KeyError:
            snap = {"instances": {}}
        by_key = {m["key"]: m for m in snap["instances"].values()}
        index: dict[str, dict] = {}
        studies: dict[str, list[str]] = {}
        reparsed = 0
        for key in self.bucket.list(self.PREFIX):
            obj = self.bucket.get(key)
            meta = by_key.get(key)
            if meta is None or meta.get("generation") != obj.generation:
                try:
                    idx = Part10Index(obj.data)
                except ValueError:
                    self.metrics.inc("dicomstore.rebuild_skipped")
                    continue
                meta = self._meta_from_index(idx, None)
                meta["key"], meta["generation"] = key, obj.generation
                reparsed += 1
            index[meta["sop_instance_uid"]] = meta
            studies.setdefault(meta["study_uid"], []).append(
                meta["sop_instance_uid"])
        with self._lock:
            self._index = index
            self._studies = studies
            self._frame_cache.clear()
        self.metrics.inc("dicomstore.rebuilds")
        return reparsed

    # ---- QIDO ---------------------------------------------------------------
    @staticmethod
    def _instance_order(meta: dict):
        return (meta["series_uid"] or "", meta["instance_number"] or 0,
                meta["sop_instance_uid"])

    def _study_metas(self, study_uid: str) -> list[dict]:
        # lock held
        return sorted((self._index[s] for s in self._studies.get(study_uid, [])),
                      key=self._instance_order)

    def search_studies(self, *, patient_id: str | None = None,
                       modality: str | None = None,
                       study_date: str | None = None) -> list[str]:
        """Study UIDs matching every given filter, in stable sorted order.

        A study matches a filter if **any** of its instances carries the
        value — instances of one study can disagree (multi-modality, merged
        patients), and judging from the first-arrived instance only would
        make results depend on delivery order.
        """
        def matches(metas: list[dict]) -> bool:
            for field, want in (("patient_id", patient_id),
                                ("modality", modality),
                                ("study_date", study_date)):
                if want is not None and \
                        not any(m[field] == want for m in metas):
                    return False
            return True

        with self._lock:
            return sorted(study for study, sops in self._studies.items()
                          if matches([self._index[s] for s in sops]))

    def search_instances(self, study_uid: str, *,
                         modality: str | None = None) -> list[dict]:
        with self._lock:
            metas = self._study_metas(study_uid)
        return [dict(m) for m in metas
                if modality is None or m["modality"] == modality]

    def study_summary(self, study_uid: str) -> dict:
        """Study-level QIDO aggregation."""
        with self._lock:
            metas = self._study_metas(study_uid)
        if not metas:
            raise KeyError(f"unknown study {study_uid}")
        return {
            "study_uid": study_uid,
            "patient_ids": sorted({m["patient_id"] for m in metas}),
            "modalities": sorted({m["modality"] for m in metas}),
            "study_dates": sorted({m["study_date"] for m in metas}),
            "n_series": len({m["series_uid"] for m in metas}),
            "n_instances": len(metas),
            "total_frames": sum(m["frames"] or 0 for m in metas),
        }

    def search_series(self, study_uid: str | None = None, *,
                      modality: str | None = None) -> list[dict]:
        """Series-level QIDO aggregation, stable (study, series) order."""
        with self._lock:
            studies = [study_uid] if study_uid is not None \
                else sorted(self._studies)
            groups: dict[tuple[str, str], list[dict]] = {}
            for study in studies:
                for m in self._study_metas(study):
                    groups.setdefault((study, m["series_uid"]), []).append(m)
        out = []
        for (study, series) in sorted(groups):
            metas = groups[(study, series)]
            if modality is not None and \
                    not any(m["modality"] == modality for m in metas):
                continue
            out.append({
                "study_uid": study,
                "series_uid": series,
                "modalities": sorted({m["modality"] for m in metas}),
                "n_instances": len(metas),
                "total_frames": sum(m["frames"] or 0 for m in metas),
            })
        return out

    # ---- WADO ----------------------------------------------------------------
    def read_blob(self, key: str) -> bytes:
        """Raw blob fetch by store key (the subscribers' re-read path);
        raises ``KeyError`` when the blob is gone (quarantined/deleted)."""
        return self.bucket.get(key).data

    def _meta(self, sop_instance_uid: str) -> dict:
        with self._lock:
            meta = self._index.get(sop_instance_uid)
        if meta is None:
            raise KeyError(f"unknown SOP instance {sop_instance_uid}")
        return meta

    def retrieve(self, sop_instance_uid: str) -> bytes:
        return self.bucket.get(self._meta(sop_instance_uid)["key"]).data

    def frame_index(self, sop_instance_uid: str) -> Part10Index:
        """The instance's Part10Index, cached per (SOP UID, generation)."""
        meta = self._meta(sop_instance_uid)
        with self._lock:
            hit = self._frame_cache.get(sop_instance_uid)
            if hit is not None and hit[0] == meta["generation"]:
                self._frame_cache.move_to_end(sop_instance_uid)
                self.metrics.inc("dicomstore.wado_index_hits")
                return hit[1]
        idx = Part10Index(self.bucket.get(meta["key"]).data)
        with self._lock:
            self._frame_cache[sop_instance_uid] = (meta["generation"], idx)
            self._frame_cache.move_to_end(sop_instance_uid)
            while len(self._frame_cache) > self.FRAME_CACHE:
                self._frame_cache.popitem(last=False)
        self.metrics.inc("dicomstore.wado_index_misses")
        return idx

    def retrieve_frame(self, sop_instance_uid: str, frame: int) -> bytes:
        """Frame-level WADO: one slice off the cached index — no reparse."""
        self.metrics.inc("dicomstore.wado_frames")
        return self.frame_index(sop_instance_uid).read_frame(frame)


class ShardedDicomStore:
    """Study-UID-hash-sharded DICOM store over N bucket partitions.

    Writes scale with the converter fleet: each study routes to exactly one
    shard (stable sha-256 hash of the study UID), so N shards take
    concurrent STOW traffic on N independent buckets, index locks, and
    checkpoints. Every shard is a full :class:`DicomStoreService` — with
    its own ``_meta/index.json`` checkpoint and per-shard
    :meth:`DicomStoreService.rebuild_index` crash recovery — but all
    shards publish on ONE shared ``dicom-instance-stored`` topic, so the
    validation/ML subscribers attach once, exactly as for the unsharded
    store.

    The DICOMweb surface (QIDO/WADO/STOW) is the same as
    ``DicomStoreService``: study-scoped calls route by hash; cross-study
    search merges the shards' (already sorted) results into one stable
    order; SOP-scoped retrieval probes the shard indexes (an O(n_shards)
    dict lookup, not a scan).

    ``crash_shard(i)`` is the fault-injection hook: it replaces shard *i*
    with a fresh service over the same bucket — all in-memory index state
    lost, exactly like an instance restart — after which
    ``rebuild_index()`` must restore byte-identical QIDO/WADO.
    """

    def __init__(self, store, scheduler, metrics=None, *, n_shards: int = 4,
                 bucket_prefix: str = "dicom-instances"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.scheduler = scheduler
        self.metrics = metrics if metrics is not None else store.metrics
        self.n_shards = n_shards
        self.topic = Topic("dicom-instance-stored", scheduler, self.metrics)
        self.buckets = [store.bucket(f"{bucket_prefix}-{i:02d}")
                        for i in range(n_shards)]
        self.shards = [DicomStoreService(b, scheduler, self.metrics,
                                         topic=self.topic)
                       for b in self.buckets]

    # ---- routing ----------------------------------------------------------
    @staticmethod
    def shard_index_for_uid(study_uid: str, n_shards: int) -> int:
        digest = hashlib.sha256(study_uid.encode()).hexdigest()
        return int(digest[:8], 16) % n_shards

    def shard_index_for(self, study_uid: str) -> int:
        return self.shard_index_for_uid(study_uid, self.n_shards)

    def shard_for(self, study_uid: str) -> DicomStoreService:
        return self.shards[self.shard_index_for(study_uid)]

    def _shard_with_sop(self, sop_instance_uid: str) -> DicomStoreService:
        for shard in self.shards:
            with shard._lock:
                if sop_instance_uid in shard._index:
                    return shard
        raise KeyError(f"unknown SOP instance {sop_instance_uid}")

    # ---- STOW -------------------------------------------------------------
    def store_instance(self, part10: bytes, *,
                       source: str | None = None) -> str:
        idx = Part10Index(part10)  # raises ValueError on corrupt input
        study = idx.get_str(0x0020, 0x000D)
        if not study:
            raise ValueError(
                "corrupt Part-10 stream: instance without SOP/study UID")
        return self.shard_for(study).store_instance(part10, source=source,
                                                    _index=idx)

    def store_study_archive(self, key: str, archive: bytes) -> list[str]:
        with tracing.span("stow.archive", key=key, shards=self.n_shards):
            stored, touched = [], set()
            for name, blob in study_levels(archive).items():
                if not name.endswith(".dcm"):
                    continue
                idx = Part10Index(blob)
                study = idx.get_str(0x0020, 0x000D)
                if not study:
                    raise ValueError(
                        "corrupt Part-10 stream: instance without "
                        "SOP/study UID")
                si = self.shard_index_for(study)
                stored.append(self.shards[si].store_instance(
                    blob, source=f"{key}/{name}", _index=idx))
                touched.add(si)
            for si in sorted(touched):
                self.shards[si].checkpoint()
        return stored

    def delete_instance(self, sop_instance_uid: str) -> dict:
        return self._shard_with_sop(sop_instance_uid).delete_instance(
            sop_instance_uid)

    # ---- durability --------------------------------------------------------
    def checkpoint(self) -> None:
        for shard in self.shards:
            shard.checkpoint()

    def rebuild_index(self) -> int:
        """Rebuild every shard; returns total blobs re-parsed."""
        return sum(shard.rebuild_index() for shard in self.shards)

    def crash_shard(self, i: int) -> DicomStoreService:
        """Fault injection: lose shard *i*'s in-memory state (index,
        studies map, frame cache) as an abrupt restart would. Its bucket —
        blobs and checkpoint — survives; ``rebuild_index()`` recovers."""
        self.shards[i] = DicomStoreService(self.buckets[i], self.scheduler,
                                           self.metrics, topic=self.topic)
        self.metrics.inc("dicomstore.shard_crashes")
        return self.shards[i]

    # ---- QIDO -------------------------------------------------------------
    def search_studies(self, **filters) -> list[str]:
        return sorted(study for shard in self.shards
                      for study in shard.search_studies(**filters))

    def search_instances(self, study_uid: str, **kw) -> list[dict]:
        return self.shard_for(study_uid).search_instances(study_uid, **kw)

    def study_summary(self, study_uid: str) -> dict:
        return self.shard_for(study_uid).study_summary(study_uid)

    def search_series(self, study_uid: str | None = None, *,
                      modality: str | None = None) -> list[dict]:
        if study_uid is not None:
            return self.shard_for(study_uid).search_series(
                study_uid, modality=modality)
        rows = [row for shard in self.shards
                for row in shard.search_series(modality=modality)]
        return sorted(rows, key=lambda r: (r["study_uid"], r["series_uid"]))

    # ---- WADO -------------------------------------------------------------
    def read_blob(self, key: str) -> bytes:
        # store keys are "instances/{study}/{series}/{sop}.dcm" — the study
        # UID in the key routes straight to the owning shard
        parts = key.split("/")
        if len(parts) >= 2 and f"{parts[0]}/" == DicomStoreService.PREFIX:
            return self.shard_for(parts[1]).read_blob(key)
        raise KeyError(f"not a sharded instance key: {key}")

    def retrieve(self, sop_instance_uid: str) -> bytes:
        return self._shard_with_sop(sop_instance_uid).retrieve(
            sop_instance_uid)

    def frame_index(self, sop_instance_uid: str) -> Part10Index:
        return self._shard_with_sop(sop_instance_uid).frame_index(
            sop_instance_uid)

    def retrieve_frame(self, sop_instance_uid: str, frame: int) -> bytes:
        return self._shard_with_sop(sop_instance_uid).retrieve_frame(
            sop_instance_uid, frame)

    # ---- introspection -----------------------------------------------------
    def shard_distribution(self) -> list[int]:
        """Indexed instances per shard (the write-scaling balance check)."""
        out = []
        for shard in self.shards:
            with shard._lock:
                out.append(len(shard._index))
        return out
