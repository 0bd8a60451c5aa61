"""attention_roofline: the least time of the traced slice's prefill
attention calls (``models.layers.blocked_attention``; the QKᵀ and PV
products the causal mask keeps at the bf16 peak, and q, k, v and the
output at the configuration's dtype; ``harness.work.attention_work``)
over the device time of the kernels each call launched, in %."""
from portbench.harness import work
from portbench.harness.readings import roofline_share


def read(run):
    if run.slice is None or not run.on_card:
        return None
    elem = work.DTYPE_BYTES[run.model["dtype"]]

    def bound(shape):
        B, S, Skv, H, KV, D, causal = shape
        return work.bound_s(*work.attention_work(B, S, H, KV, D, elem),
                            work.PEAK["bf16_flops"])
    return roofline_share(run.slice.calls.get("attention", []), bound)
