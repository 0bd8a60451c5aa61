"""The system under test and the closed loop that drives it.

One ``ContinuousBatchingEngine`` (decode as a CUDA graph on the card)
behind ``PubSubFrontend`` on the program's bus (``Topic``,
``Subscription`` over a ``SimScheduler``): each client publishes its
request on the request topic and, when its answer arrives on the response
topic, publishes the next. The loop alternates an engine tick with a drain
of the bus; the bus's deliveries submit requests, and the engine prefills
a request as it is submitted.

The benchmark's own wrappers around calls into the engine take the
timestamps (host clock, ``time.perf_counter``):

- ``_prefill_into`` (the prefill and the read-back of its first token,
  which synchronises): the first token's time and the prefill's span;
- ``_decode`` and the ``_greedy`` read-back that follows it: a tick's
  span, how many slots appended a token, the context each token attended
  to, and the time of each request's last token.

The front end publishes an answer when it finishes, so no token reaches
the client before that: the first and last tokens are timed where they
reach the host, the point at which a streaming front end would publish
them; a request's start is its publish at the client.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

__all__ = ["Req", "Timing", "System", "clock"]

clock = time.perf_counter


@dataclasses.dataclass
class Req:
    rid: int
    client: int
    prompt: np.ndarray
    max_new: int
    t_publish: float
    t_first: float | None = None
    t_last: float | None = None
    t_done: float | None = None
    tokens: list | None = None


@dataclasses.dataclass
class Timing:
    """What the window recorded, for the metric readers."""

    t0: float = 0.0
    t1: float = 0.0
    prefills: list = dataclasses.field(default_factory=list)  # (t0, t1, S)
    # (t0, t1, n, ctx): ctx the context of each token appended
    ticks: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class System:
    """The engine, its front end, the bus and the clients of one cell."""

    def __init__(self, cfg, params, mix, stream, primers):
        from repro_torch.core import SimScheduler, Subscription, Topic
        from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                              PubSubFrontend)

        self.mix = mix
        self.sched = SimScheduler()
        self.req_topic = Topic("requests", self.sched)
        self.resp_topic = Topic("responses", self.sched)
        self.engine = ContinuousBatchingEngine(
            cfg, params, batch_size=mix.slots, max_len=mix.max_len)
        self.frontend = PubSubFrontend(self.engine, self.req_topic,
                                       self.resp_topic)
        Subscription(self.resp_topic, "clients", self._on_answer)
        self.stream = stream
        self.requests: dict[int, Req] = {}
        self.timing = Timing()
        self.recording = False
        self._ids = itertools.count()
        self._by_engine_id: dict[int, int] = {}
        self._incoming = None
        self._tick_start = None
        self._tick_meta = None
        self._wrap()
        for client, (prompt, n) in enumerate(primers):
            self._send(client, prompt, n)

    # ---- the clients --------------------------------------------------------
    def _send(self, client: int, prompt: np.ndarray, n: int) -> None:
        rid = next(self._ids)
        self.requests[rid] = Req(rid, client, prompt, n, clock())
        self.req_topic.publish({"request_id": rid, "prompt": prompt,
                                "max_new_tokens": n})

    def _on_answer(self, msg, ctx) -> None:
        req = self.requests[msg.data["request_id"]]
        req.t_done = clock()
        req.tokens = list(msg.data["tokens"])
        ctx.ack()
        self._send(req.client, *next(self.stream))

    # ---- the wrappers ---------------------------------------------------------
    def _wrap(self) -> None:
        eng, fe = self.engine, self.frontend
        endpoint, submit = fe.sub.endpoint, eng.submit
        prefill, decode, greedy = eng._prefill_into, eng._decode, eng._greedy

        def on_message(msg, ctx):
            self._incoming = msg.data["request_id"]
            endpoint(msg, ctx)

        def on_submit(req):
            self._by_engine_id[req.req_id] = self._incoming
            submit(req)

        def on_prefill(b, req):
            t0 = clock()
            prefill(b, req)
            t1 = clock()
            mine = self.requests[self._by_engine_id[req.req_id]]
            mine.t_first = t1
            if self.recording:
                self.timing.prefills.append((t0, t1, len(req.prompt)))

        def on_decode():
            # the slots this tick appends a token to, and their contexts
            live = [(b, r) for b, r in enumerate(eng.active)
                    if r is not None and eng.budget[b] > 0]
            self._tick_meta = (
                len(live),
                np.array([int(eng.pos[b]) + 1 for b, _ in live], np.int32),
                [self._by_engine_id[r.req_id] for b, r in live
                 if eng.budget[b] == 1])
            self._tick_start = clock()
            return decode()

        def on_greedy(logits):
            out = greedy(logits)
            if self._tick_start is not None:
                t1 = clock()
                n, ctx, last = self._tick_meta
                for rid in last:
                    self.requests[rid].t_last = t1
                if self.recording:
                    self.timing.ticks.append((self._tick_start, t1, n, ctx))
                self._tick_start = None
            return out

        fe.sub.endpoint = on_message
        eng.submit = on_submit
        eng._prefill_into = on_prefill
        eng._decode = on_decode
        eng._greedy = on_greedy

    def hook(self, name: str, wrapper) -> None:
        """Wrap engine attribute ``name`` once more, outermost (the tests'
        planted faults)."""
        setattr(self.engine, name, wrapper(getattr(self.engine, name)))

    # ---- the loop -------------------------------------------------------------
    def deliver(self) -> None:
        self.sched.run(until=self.sched.now())

    def step(self) -> None:
        self.engine.tick()
        self.deliver()

    def warm_up(self) -> None:
        """The primers' prefills, the eager tick and the graph's capture."""
        self.deliver()
        self.engine.tick()
        self.engine.tick()
        self.deliver()
        self.sync()

    def sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def run(self, seconds: float, record: bool) -> None:
        """Loop for ``seconds`` of host time (the last tick may cross it)."""
        self.recording = record
        t0 = clock()
        if record:
            self.timing.t0 = t0
        end = t0 + seconds
        while True:
            self.step()
            if clock() >= end:
                break
        self.sync()
        if record:
            self.timing.t1 = clock()
        self.recording = False
