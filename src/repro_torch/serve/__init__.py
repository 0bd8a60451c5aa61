"""Serving: the continuous-batching engine."""
from repro_torch.serve.engine import (  # noqa: F401
    ContinuousBatchingEngine,
    Request,
)
