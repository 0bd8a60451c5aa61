"""The port's copy of ``repro.core``: the paper's event-driven spine.

Object storage with creation notifications, a topic-based pub/sub broker
with at-least-once push delivery (ack deadlines, retries, DLQ, hedging), a
Cloud-Run-style autoscaling worker service and the converter fleet, and the
Figure-1 conversion pipeline wiring — runnable deterministically under a
discrete-event scheduler or on real threads, with the port's converter on
the card doing the real work.

Observability rides the same spine: :mod:`repro_torch.core.tracing`
threads one span tree per slide through every hop, :mod:`repro_torch.core
.metrics` adds latency histograms, and :mod:`repro_torch.core.dashboard`
folds both into one report.
"""
from repro_torch.core import dashboard, tracing  # noqa: F401
from repro_torch.core.autoscaler import AutoscalingService  # noqa: F401
from repro_torch.core.clock import RealScheduler, SimScheduler  # noqa: F401
from repro_torch.core.fleet import ConverterFleet  # noqa: F401
from repro_torch.core.metrics import Metrics  # noqa: F401
from repro_torch.core.pipeline import ConversionPipeline  # noqa: F401
from repro_torch.core.pubsub import (DeliveryCtx,  # noqa: F401
                                     DeliveryFaults, Message, Subscription,
                                     Topic)
from repro_torch.core.storage import (Bucket, LifecycleRule,  # noqa: F401
                                      Object, ObjectStore)
