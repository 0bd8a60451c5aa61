"""Arithmetic the metric readers share: a percentile over all requests,
the model FLOPs of the window, a roofline share over traced calls."""
from __future__ import annotations

import numpy as np

from portbench.harness import work

__all__ = ["p90", "ttft_p90_ms", "window_flops", "roofline_share",
           "prefill_ms_per_ktok", "mfu", "idle_share"]


def p90(values) -> float | None:
    """The 90th percentile (linear between order statistics) of every
    value, or None for none."""
    values = list(values)
    return float(np.percentile(values, 90)) if values else None


def ttft_p90_ms(run) -> float | None:
    """From a request's publish at its client to its first token on the
    host, p90 over every request whose first token came in the window."""
    return p90(1e3 * (r.t_first - r.t_publish) for r in run.requests
               if run.in_window(r.t_first))


def window_flops(run) -> float:
    """The model FLOPs the window's work needs: each prefill completed in
    it and each token a tick in it appended (``work``, with the family's
    ``token_flops`` from the cell's reference)."""
    m, ref = run.model, run.reference
    flops = sum(work.prefill_flops(ref, m, S)
                for _, _, S in run.timing.prefills)
    ctx = [c for _, _, _, c in run.timing.ticks]
    return flops + work.decode_flops(ref, m, np.concatenate(ctx) if ctx
                                     else np.zeros(0, np.int64))


def roofline_share(calls, bound) -> float | None:
    """100 × the least time of the calls (``bound(shape)`` seconds each)
    over their device time, or None where no call ran a kernel."""
    device = sum(t for _, t in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(bound(shape) for shape, _ in calls) / device


def prefill_ms_per_ktok(run) -> float | None:
    """Host time inside the engine's ``_prefill_into`` (the prefill and its
    first token's read-back, which synchronises) over the window, per 1000
    prompt tokens."""
    pre = run.timing.prefills
    tokens = sum(S for _, _, S in pre)
    if not tokens:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in pre) / (tokens / 1e3)


def mfu(run) -> float | None:
    """The whole step's share of the card's bf16 peak: the model FLOPs the
    window's prefills and decoded tokens need, over the window's length
    times 989 TFLOP/s, in %. Read on the card only."""
    if not run.on_card:
        return None
    return 100.0 * window_flops(run) / (run.window_s
                                         * work.PEAK["bf16_flops"])


def idle_share(run) -> float | None:
    """The device's idle share of the traced slice: 1 - (the union of its
    kernels' intervals and any untraced graph replays) / the slice, in %.
    Read on the card only."""
    sl = run.slice
    if sl is None or not run.on_card or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
