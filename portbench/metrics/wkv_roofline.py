"""wkv_roofline: the least time of the wkv recurrence in the traced slice's
prefills (one call a layer over the prompt, ``harness.work.wkv_work`` at
the float32 peak and the memory rate) over the device time of the wkv
kernels (``wkv_*``) each prefill launched, in %."""
from portbench.harness import work
from portbench.harness.readings import roofline_share


def read(run):
    if run.slice is None or not run.on_card:
        return None
    m = run.model
    L, H, K = m["num_layers"], m["num_heads"], m["head_dim"]

    def bound(tag):
        (S,) = tag
        return L * work.bound_s(*work.wkv_work(1, S, H, K),
                                work.PEAK["f32_flops"])
    return roofline_share(run.slice.calls.get("wkv", []), bound)
