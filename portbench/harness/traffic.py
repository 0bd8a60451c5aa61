"""The one traffic generator: a mix file's parameters → requests.

A mix (``portbench/traffic/<name>.json``) gives ``clients`` (each a
closed loop: it sends its next request when the previous answer has
arrived), ``slots`` and ``max_len`` for the engine, the length
distributions ``prompt_tokens`` and ``output_tokens`` as quantile tables
(``[[quantile, tokens], ...]`` from quantile 0 to 1, read as a
piecewise-linear inverse distribution function) and a ``block`` size.
Requests come in blocks: each block holds the same ``block`` prompt
lengths and the same ``block`` output lengths, those at the quantiles
``(i + 0.5) / block``, paired and ordered by the seed. Every seed so
serves the same mix of sizes in another order, and a window that
completes some blocks has done nearly the same work on every seed.
Prompt tokens are uniform over the vocabulary.

Each client's first request (the primers, sent in set-up) stands for a
request already under way, so that the window opens in the steady state
rather than with every slot new: the C clients ask for the quantiles
``(i + 0.5) / C`` of the tokens a request in progress still has to
serve, the residual of the block's output lengths (a request of length n
is under way for n ticks, so the residual r has weight
``#{lengths >= r}``), handed to the clients in an order drawn from the
seed, so that the requests that finish first are spread over the slots. Client 0's prompt is the longest of the mix (the
largest prefill shape is warmed up), the others' the shortest.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["Mix", "at_quantiles", "requests", "residuals", "primers"]


def _table(name: str, rows) -> tuple[tuple[float, int], ...]:
    rows = tuple((float(q), int(n)) for q, n in rows)
    qs = [q for q, _ in rows]
    ns = [n for _, n in rows]
    if len(rows) < 2 or qs[0] != 0.0 or qs[-1] != 1.0 or \
            any(b <= a for a, b in zip(qs, qs[1:])) or \
            any(b < a for a, b in zip(ns, ns[1:])) or ns[0] < 1:
        raise ValueError(f"{name}: a quantile table runs from quantile 0 to "
                         f"1, both rising, lengths from 1 (got {rows})")
    return rows


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    slots: int
    max_len: int
    prompt_tokens: tuple[tuple[float, int], ...]
    output_tokens: tuple[tuple[float, int], ...]
    block: int
    check_min_served_tokens: int
    check_max_requests: int

    @property
    def prompt_range(self) -> tuple[int, int]:
        return self.prompt_tokens[0][1], self.prompt_tokens[-1][1]

    @property
    def output_range(self) -> tuple[int, int]:
        return self.output_tokens[0][1], self.output_tokens[-1][1]

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        if d.get("loop", "closed") != "closed":
            raise ValueError(f"mix {d['name']}: only closed loops are "
                             f"generated (got {d.get('loop')!r})")
        mix = cls(name=d["name"], clients=int(d["clients"]),
                  slots=int(d["slots"]), max_len=int(d["max_len"]),
                  prompt_tokens=_table(f"mix {d['name']} prompt_tokens",
                                       d["prompt_tokens"]),
                  output_tokens=_table(f"mix {d['name']} output_tokens",
                                       d["output_tokens"]),
                  block=int(d["block"]),
                  check_min_served_tokens=int(d["check_min_served_tokens"]),
                  check_max_requests=int(d["check_max_requests"]))
        # the engine appends a token while its position stays below
        # max_len - 1: every request must get all it asks for
        most = mix.prompt_range[1] + mix.output_range[1]
        if most >= mix.max_len:
            raise ValueError(f"mix {mix.name}: prompt + output up to {most} "
                             f"tokens does not fit max_len {mix.max_len}")
        if mix.clients > mix.slots:
            raise ValueError(f"mix {mix.name}: {mix.clients} clients for "
                             f"{mix.slots} slots would queue in the engine")
        return mix


def at_quantiles(table, n: int) -> np.ndarray:
    """The lengths at the quantiles ``(i + 0.5) / n`` of a quantile table,
    linear between its rows, rounded to whole tokens."""
    qs = [q for q, _ in table]
    ns = [v for _, v in table]
    at = (np.arange(n) + 0.5) / n
    return np.rint(np.interp(at, qs, ns)).astype(np.int64)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), stream])


def requests(mix: Mix, vocab: int, seed: int) -> Iterator[tuple]:
    """``(prompt int32 array, max_new_tokens)`` without end."""
    rng = _rng(seed, 1)
    prompts = at_quantiles(mix.prompt_tokens, mix.block)
    outs = at_quantiles(mix.output_tokens, mix.block)
    while True:
        for s, n in zip(rng.permutation(prompts), rng.permutation(outs)):
            yield (rng.integers(0, vocab, size=int(s), dtype=np.int32),
                   int(n))


def residuals(mix: Mix, n: int) -> np.ndarray:
    """The tokens ``n`` requests in progress still have to serve, at the
    quantiles ``(i + 0.5) / n`` of the residual of the block's output
    lengths (module doc), shortest first."""
    lengths = at_quantiles(mix.output_tokens, mix.block)
    r = np.arange(1, lengths.max() + 1)
    weight = (lengths[None, :] >= r[:, None]).sum(1)
    cdf = np.cumsum(weight) / weight.sum()
    at = (np.arange(n) + 0.5) / n
    return r[np.searchsorted(cdf, at)]


def primers(mix: Mix, vocab: int, seed: int) -> list[tuple]:
    """Each client's first request (module doc)."""
    rng = _rng(seed, 2)
    lo, hi = mix.prompt_range
    left = rng.permutation(residuals(mix, mix.clients))
    out = []
    for c, n in enumerate(left):
        s = hi if c == 0 else lo
        out.append((rng.integers(0, vocab, size=s, dtype=np.int32), int(n)))
    return out
