"""prefill_ms_per_ktok.prompt: host time in the engine's prefill per 1000
prompt tokens over the window (``harness.readings``)."""
from portbench.harness.readings import prefill_ms_per_ktok as read  # noqa: F401
