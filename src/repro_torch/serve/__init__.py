"""Serving: the continuous-batching engine and its event-bus front end."""
from repro_torch.serve.engine import (  # noqa: F401
    ContinuousBatchingEngine,
    PubSubFrontend,
    Request,
)
