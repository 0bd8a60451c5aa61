"""tpot_p90_ms: per request answered in the window whose first token also
came in it, (last token - first token) / (tokens - 1), p90 over all of
them."""
from portbench.harness.readings import p90


def read(run):
    return p90(1e3 * (r.t_last - r.t_first) / (len(r.tokens) - 1)
               for r in run.requests
               if run.in_window(r.t_done) and run.in_window(r.t_first)
               and len(r.tokens) > 1)
