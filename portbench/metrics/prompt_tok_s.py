"""prompt_tok_s: prompt tokens of every prefill completed in the window,
over the window's length."""


def read(run):
    return sum(S for _, _, S in run.timing.prefills) / run.window_s
