"""Object storage with creation notifications and lifecycle tiers.

The bucket is the pipeline's landing zone: every finalized write emits an
``OBJECT_FINALIZE`` notification to the configured pub/sub topic — the
paper's storage→event→topic wiring. Writes are content-addressed
(generation = hash), which makes downstream conversion idempotent: a retried
or hedged conversion writing identical bytes is a no-op, so at-least-once
delivery composes into effectively-once conversion.

Lifecycle rules move objects between STANDARD → NEARLINE → COLDLINE →
ARCHIVE by age (the paper's cost-tiering) without changing their content or
identity.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.core.metrics import Metrics
from repro_torch.core.pubsub import Topic

__all__ = ["ObjectStore", "Bucket", "Object", "LifecycleRule", "CLASSES"]

CLASSES = ("STANDARD", "NEARLINE", "COLDLINE", "ARCHIVE")


@dataclasses.dataclass
class Object:
    key: str
    data: bytes
    generation: str
    created: float
    updated: float
    storage_class: str = "STANDARD"
    metadata: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.data)


@dataclasses.dataclass(frozen=True)
class LifecycleRule:
    age: float  # seconds since creation
    to_class: str


class Bucket:
    def __init__(self, name: str, scheduler, metrics: Metrics):
        self.name = name
        self.scheduler = scheduler
        self.metrics = metrics
        self._objects: dict[str, Object] = {}
        self._lock = TrackedLock(f"Bucket[{name}]._lock")
        # (topic, events, prefix, ordered)
        self._notify: list[tuple[Topic, str, str, bool]] = []
        self.lifecycle: list[LifecycleRule] = []

    # ---- notification config ---------------------------------------------
    def add_notification(self, topic: Topic, event_types: str = "OBJECT_FINALIZE",
                         prefix: str = "", *, ordered: bool = False):
        """``ordered=True`` keys notifications by object key, so successive
        events for the same object (re-uploads racing a slow conversion)
        deliver one-at-a-time in publish order through the broker."""
        self._notify.append((topic, event_types, prefix, ordered))

    def _emit(self, event_type: str, obj: Object):
        payload = {
            "eventType": event_type,
            "bucket": self.name,
            "name": obj.key,
            "generation": obj.generation,
            "size": obj.size,
            "timeCreated": obj.created,
            "storageClass": obj.storage_class,
            "metadata": dict(obj.metadata),
        }
        for topic, types, prefix, ordered in self._notify:
            if event_type in types and obj.key.startswith(prefix):
                topic.publish(payload, attributes={"eventType": event_type},
                              ordering_key=obj.key if ordered else None)

    # ---- object ops --------------------------------------------------------
    def put(self, key: str, data: bytes, metadata: dict | None = None,
            if_generation_match: str | None = None) -> Object:
        gen = hashlib.sha256(data).hexdigest()[:16]
        now = self.scheduler.now()
        with self._lock:
            prev = self._objects.get(key)
            if prev is not None and prev.generation == gen:
                self.metrics.inc(f"bucket.{self.name}.idempotent_skips")
                return prev  # identical content: idempotent, no re-notify
            if if_generation_match is not None and prev is not None \
                    and prev.generation != if_generation_match:
                raise ValueError(f"generation mismatch on {key}")
            obj = Object(key=key, data=data, generation=gen, created=now,
                         updated=now, metadata=metadata or {})
            self._objects[key] = obj
        self.metrics.inc(f"bucket.{self.name}.writes")
        self.metrics.inc(f"bucket.{self.name}.bytes", len(data))
        self._emit("OBJECT_FINALIZE", obj)
        return obj

    def get(self, key: str) -> Object:
        with self._lock:
            obj = self._objects.get(key)
        if obj is None:
            raise KeyError(f"gs://{self.name}/{key} not found")
        self.metrics.inc(f"bucket.{self.name}.reads")
        return obj

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def delete(self, key: str):
        with self._lock:
            obj = self._objects.pop(key, None)
        if obj is not None:
            self._emit("OBJECT_DELETE", obj)

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    # ---- lifecycle -----------------------------------------------------------
    def add_lifecycle_rule(self, rule: LifecycleRule):
        assert rule.to_class in CLASSES
        self.lifecycle.append(rule)

    def apply_lifecycle(self):
        """Run lifecycle transitions as of 'now' (cron-style sweep)."""
        now = self.scheduler.now()
        moved = 0
        with self._lock:
            for obj in self._objects.values():
                age = now - obj.created
                target = obj.storage_class
                for rule in sorted(self.lifecycle, key=lambda r: r.age):
                    if age >= rule.age:
                        target = rule.to_class
                if target != obj.storage_class:
                    obj.storage_class = target
                    moved += 1
        if moved:
            self.metrics.inc(f"bucket.{self.name}.lifecycle_moves", moved)
        return moved


class ObjectStore:
    """A project's buckets + shared scheduler/metrics."""

    def __init__(self, scheduler, metrics: Metrics | None = None):
        self.scheduler = scheduler
        self.metrics = metrics or Metrics(scheduler)
        self.buckets: dict[str, Bucket] = {}

    def bucket(self, name: str) -> Bucket:
        if name not in self.buckets:
            self.buckets[name] = Bucket(name, self.scheduler, self.metrics)
        return self.buckets[name]
