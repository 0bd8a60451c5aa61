"""ttft_p90_ms: from a request's publish at its client to its first token
on the host, p90 over every request whose first token came in the window
(``harness.readings``)."""
from portbench.harness.readings import ttft_p90_ms as read  # noqa: F401
