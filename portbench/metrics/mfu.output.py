"""mfu.output: the model FLOPs the window's work needs over the window at the
bf16 peak, in % (``harness.readings``, ``harness.work``)."""
from portbench.harness.readings import mfu as read  # noqa: F401
