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
(:mod:`repro_torch.core.pubsub`). The cache lives on the parameters'
device; the slot splice writes into it in place, and so does the decode
step (``serve.steps.make_decode_step``, the step the dry run counts).

Where the reference jits its decode step, the engine on a CUDA device
runs it as one CUDA graph (``graphs``; ``serve.steps.DecodeGraph``): the
first decode tick runs the step eagerly (the warm-up), the second
captures it over the live cache and replays it once to do its work, and
every later tick replays it, after checking that every leaf of the cache
and the parameters is the tensor the graph captured (a changed leaf
raises ``RuntimeError``; nothing falls back to the eager step). The
logits a replay returns live in the graph's static buffer and are
overwritten by the next replay: the argmax and its read-back stay
outside the graph (:meth:`_greedy`), as the reference takes its argmax
outside ``jit``. ``graphs=False`` is the eager engine, one step call a
tick. The prefill runs eagerly in both, as the reference's does.
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
from repro_torch.serve.steps import DecodeGraph, make_decode_step

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
    are conditioned on zeros (the reference's stub frontend).

    ``graphs`` (module doc): ``None`` runs the decode step as a CUDA graph
    when the cache lives on a CUDA device and eagerly otherwise; ``True``
    on a CPU cache raises ``ValueError``; ``False`` is the eager engine.
    ``graph_captures`` and ``graph_replays`` count the graph's captures
    (at most 1) and replays (one a decode tick from the second on)."""

    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 impl: str = "auto", graphs: bool | None = None):
        self.cfg = cfg
        self.params = params
        self.impl = impl
        self.device = params["embed"]["table"].device
        self.B = batch_size
        self.max_len = max_len
        self.cache = M.init_cache(cfg, batch_size, max_len, self.device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"graphs=True needs a CUDA cache; this one "
                             f"lives on {self.device}")
        self.graphs = on_card if graphs is None else graphs
        self._step = make_decode_step(cfg)
        self._graph: DecodeGraph | None = None
        self.graph_captures = 0
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
        nxt = self._greedy(self._decode())
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

    def _decode(self) -> torch.Tensor:
        """One decode step over every slot: eager on the first tick (and
        always without graphs), captured on the second, replayed from then
        on (module doc). Returns the (B, V) logits."""
        if self._graph is None and self.graphs and self.steps >= 1:
            self._graph = DecodeGraph(self._step, self.params, self.cache,
                                      self.B)
            self.graph_captures += 1
        if self._graph is not None:
            return self._graph(self._last_tok, self.pos)
        toks = torch.as_tensor(self._last_tok, device=self.device)[:, None]
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = self._step(self.params, self.cache, toks.long(),
                                        pos)
        return logits

    @property
    def graph_replays(self) -> int:
        return 0 if self._graph is None else self._graph.replays

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
