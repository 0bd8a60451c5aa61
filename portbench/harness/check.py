"""Whether what the timed path served is right: the plain reference's
judgement of the served tokens.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished is drawn from the seed (the longest of
them first, then others until ``check_min_served_tokens`` tokens or
``check_max_requests`` requests). For each, the reference runs once over
its prompt and its served tokens; at each served token the gap by which
the reference's logit of that token lies below the reference's best is
read. The first served token is the prefill's argmax, the others the
decode graph's through the cache, so both are judged at the timed sizes.
``max_logit_gap`` (the widest gap) is held to the cell's limit
(``cells/<cell>.json``). The control (:func:`control_gaps`) reads, at the
same positions, the gap of the token the reference computed with float8
operands puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.common import FLOAT8, float32_exact

__all__ = ["sample", "served_gaps", "control_gaps"]


def sample(finished: list, seed: int, min_tokens: int,
           max_requests: int) -> list:
    """``finished``: requests with ``prompt`` and ``tokens``. The longest
    (prompt and answer) first, then others in an order drawn from
    ``seed``."""
    if not finished:
        return []
    ranked = sorted(finished, key=lambda r: (-(len(r.prompt)
                                                + len(r.tokens)), r.rid))
    rest = ranked[1:]
    rng = np.random.default_rng([seed & (2**64 - 1), 3])
    picked, served = [ranked[0]], len(ranked[0].tokens)
    for i in rng.permutation(len(rest)):
        if served >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        served += len(rest[i].tokens)
    return picked


def _logits(ref, params, model, req, device, **kw):
    seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
    toks = torch.as_tensor(seq, device=device).long()
    with torch.no_grad(), float32_exact():
        return ref.logits(params, model, toks, len(req.prompt) - 1, **kw)


def served_gaps(ref, params, model, req, device) -> np.ndarray:
    """The reference's best logit less its logit of each served token."""
    lg = _logits(ref, params, model, req, device)
    idx = torch.as_tensor(req.tokens, device=lg.device).long()
    got = lg.gather(1, idx[:, None])[:, 0]
    return (lg.max(-1).values - got).cpu().numpy()


def control_gaps(ref, params, model, req, device) -> np.ndarray:
    """The gap of the token the float8 reference puts first."""
    lg = _logits(ref, params, model, req, device)
    low = _logits(ref, params, model, req, device, prec=FLOAT8)
    pick = low.argmax(-1)
    got = lg.gather(1, pick[:, None])[:, 0]
    return (lg.max(-1).values - got).cpu().numpy()
