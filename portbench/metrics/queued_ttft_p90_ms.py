"""queued_ttft_p90_ms: ``ttft_p90_ms`` of a cell whose closed loop keeps
every slot busy, so that a request waits behind the prefills queued ahead
of it. At capacity such a tail swings with the smallest change, so it is
read as a per-layer metric beside the rate it follows
(``harness.readings``)."""
from portbench.harness.readings import ttft_p90_ms as read  # noqa: F401
