"""idle_share.output: the device's idle share of the traced slice, in %
(``harness.readings``, ``harness.trace``)."""
from portbench.harness.readings import idle_share as read  # noqa: F401
