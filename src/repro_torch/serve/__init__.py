"""Serving: step builders, the continuous-batching engine and its
event-bus front end."""
from repro_torch.serve.engine import (  # noqa: F401
    ContinuousBatchingEngine,
    PubSubFrontend,
    Request,
)
from repro_torch.serve.steps import (  # noqa: F401
    decode_input_defs,
    make_decode_step,
    make_prefill_step,
    prefill_input_defs,
)
