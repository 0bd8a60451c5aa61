"""output_tok_s: tokens served in the window (each prefill's first token
and each token a tick appended), over the window's length."""


def read(run):
    first = len(run.timing.prefills)
    return (first + sum(n for _, _, n, _ in run.timing.ticks)) / run.window_s
