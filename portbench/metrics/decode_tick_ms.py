"""decode_tick_ms: host time of the engine's ``_decode`` (the decode
graph's replay) and the argmax read-back after it, over every tick of the
window, per tick."""


def read(run):
    ticks = run.timing.ticks
    if not ticks:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _, _ in ticks) / len(ticks)
