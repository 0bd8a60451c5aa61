"""Continuous-batching serving engine with event-driven intake, a copy of
``repro.serve.engine``.

The paper's pattern applied to LM serving: requests land on a pub/sub topic
(the "landing zone"), a push subscription feeds engine instances (the
"containers"), results publish to a response topic. Inside one engine:

* a fixed-size slot array (the decode batch) over one shared cache,
* per-request prefill (batch 1) writes its state into a free slot,
* one ``decode_step`` per tick advances every active slot together
  (continuous batching: no head-of-line blocking on long generations),
* finished slots free immediately and the backlog refills them.

The engine is synchronous and deterministic (tests drive ``tick()``
directly); ``PubSubFrontend`` adapts it to the port's event bus
(:mod:`repro_torch.core.pubsub`). Decode runs eagerly, one ``decode_step``
call per tick. The cache lives on the parameters' device; the slot splice
writes into it in place, and so does the decode step.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core.pubsub import Subscription
from repro_torch.models import model as M
from repro_torch.models.params import tree_map

__all__ = ["ContinuousBatchingEngine", "PubSubFrontend", "Request",
           "splice_slot", "zero_cond"]

_ids = itertools.count(1)


def zero_cond(cfg, device):
    """The conditioning the engine feeds the vlm and audio families (the
    reference's stub frontend): zeros of (1, n_cross_tokens, d_model) in
    the compute dtype; None for the other families."""
    if cfg.family not in ("vlm", "audio"):
        return None
    return torch.zeros((1, cfg.n_cross_tokens, cfg.d_model),
                       dtype=cfg.dtype, device=device)


def splice_slot(cache, one, b: int, slots: int) -> None:
    """Write a batch-1 prefill cache ``one`` into slot ``b`` of the
    ``slots``-slot ``cache``, in place, by the reference's two rules: a
    layer-stacked leaf (L, B, ...) — the K/V (L, B, W, KV, hd), their int8
    scales, the cross and shared K/V, the ssm and Mamba2 states — at
    [:, b]; a per-slot leaf (B, ...) — kv_pos (B, W) — at [b]."""
    def splice(dst, src):
        if dst.dim() >= 2 and src.shape[1] == 1 and dst.shape[1] == slots:
            dst[:, b] = src[:, 0].to(dst.dtype)
        elif src.shape[0] == 1 and dst.shape[0] == slots:  # (B, ...)
            dst[b] = src[0].to(dst.dtype)

    tree_map(splice, cache, one)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    done: Callable | None = None  # callback(tokens)


class ContinuousBatchingEngine:
    """Greedy decoding (argmax, the first index on ties, in
    :meth:`_greedy`); ``greedy`` is accepted and unread, as in the
    reference. ``impl`` goes to the ssm prefill's wkv
    (:func:`repro_torch.models.model.prefill`). The vlm and audio families
    are conditioned on zeros (the reference's stub frontend)."""

    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 impl: str = "auto"):
        self.cfg = cfg
        self.params = params
        self.impl = impl
        self.device = params["embed"]["table"].device
        self.B = batch_size
        self.max_len = max_len
        self.cache = M.init_cache(cfg, batch_size, max_len, self.device)
        self.pos = np.zeros(batch_size, np.int32)
        self.active: list[Request | None] = [None] * batch_size
        self.budget = np.zeros(batch_size, np.int32)
        self.generated: dict[int, list[int]] = {}
        self.backlog: deque[Request] = deque()
        self.steps = 0
        self._last_tok = np.zeros(batch_size, np.int32)

    # ---- intake -----------------------------------------------------------
    def submit(self, req: Request):
        self.backlog.append(req)
        self._fill_slots()

    def _fill_slots(self):
        for b in range(self.B):
            if self.active[b] is None and self.backlog:
                req = self.backlog.popleft()
                self._prefill_into(b, req)

    def _prefill_into(self, b: int, req: Request):
        S = len(req.prompt)
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                               device=self.device)[None].long()
        logits, cache1 = M.prefill(self.params, self.cfg, toks,
                                   cond=zero_cond(self.cfg, self.device),
                                   max_len=self.max_len, impl=self.impl)
        splice_slot(self.cache, cache1, b, self.B)
        tok = int(self._greedy(logits)[0])
        self.active[b] = req
        self.pos[b] = S
        self.budget[b] = req.max_new_tokens - 1
        self.generated[req.req_id] = [tok]
        self._last_tok[b] = tok

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        """(rows, V) logits → each row's token, on the host."""
        return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)

    # ---- decode tick -----------------------------------------------------
    def tick(self) -> int:
        """One decode step over all active slots. Returns #active."""
        if not any(r is not None for r in self.active):
            self._fill_slots()
            if not any(r is not None for r in self.active):
                return 0
        toks = torch.as_tensor(self._last_tok, device=self.device)[:, None]
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = M.decode_step(self.params, self.cfg, self.cache,
                                           toks.long(), pos)
        nxt = self._greedy(logits)
        self.steps += 1
        for b, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[b] += 1
            tok = int(nxt[b])
            out = self.generated[req.req_id]
            if self.budget[b] > 0 and (req.eos_id is None or tok != req.eos_id) \
                    and self.pos[b] < self.max_len - 1:
                out.append(tok)
                self.budget[b] -= 1
                self._last_tok[b] = tok
            else:
                self._finish(b, req)
        self._fill_slots()
        return sum(r is not None for r in self.active)

    def _finish(self, b: int, req: Request):
        tokens = self.generated.pop(req.req_id)
        self.active[b] = None
        if req.done:
            req.done(tokens)

    def run_until_drained(self, max_steps: int = 10_000):
        while (self.backlog or any(self.active)) and self.steps < max_steps:
            self.tick()


class PubSubFrontend:
    """Event-bus adapter: request topic → engine, results → response topic.

    Each message (``{"request_id", "prompt", "max_new_tokens"}``) is
    submitted to the engine; it is acked only when its request finishes,
    after its tokens are published (``{"request_id", "tokens"}``), so an
    engine that dies mid-request leaves it to redeliver.
    """

    def __init__(self, engine: ContinuousBatchingEngine, topic, response_topic,
                 name: str = "llm-serve"):
        self.engine = engine
        self.response_topic = response_topic
        self.sub = Subscription(topic, name, self._on_message,
                                ack_deadline=300.0)

    def _on_message(self, msg, ctx):
        data = msg.data

        def done(tokens):
            self.response_topic.publish(
                {"request_id": data.get("request_id"), "tokens": tokens})
            ctx.ack()

        self.engine.submit(Request(
            prompt=np.asarray(data["prompt"], np.int32),
            max_new_tokens=int(data.get("max_new_tokens", 16)),
            done=done,
        ))
