"""Elastic data-parallel training orchestration over the event bus, a copy
of ``repro.train.elastic`` on the port's ``core.pubsub``.

The paper's dispatch pattern applied to a trainer fleet: data shards are
pub/sub messages, trainer workers are subscribers, and the parameter server
applies worker gradients. Failure semantics compose exactly like the
conversion pipeline's:

* a worker that dies mid-shard never acks → the shard redelivers to a
  healthy worker (at-least-once ⇒ no data loss on preemption),
* gradient application is keyed by (epoch, shard) → a redelivered shard a
  dead worker *did* finish is ignored (effectively-once updates),
* workers can join/leave at any time (elastic scaling): throughput tracks
  the live worker count, correctness doesn't depend on it.

This is the *job-level* layer — within a worker a step is still one
synchronous program on the state's device. ``ElasticTrainer.run_epoch``
drives everything on the deterministic SimScheduler so the fault-injection
tests are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.pubsub import Subscription, Topic
from repro_torch.train.optim import TrainConfig, adamw_update
from repro_torch.train.step import loss_and_grads

__all__ = ["ElasticTrainer", "Worker"]


@dataclasses.dataclass
class Worker:
    name: str
    speed: float = 1.0  # relative step rate (sim time per shard = base/speed)
    alive: bool = True


class ElasticTrainer:
    """Parameter server + worker fleet over a shard topic.

    ``state`` is a train state (``train.step.init_train_state``), updated
    in place; ``batch_fn(shard)`` returns a batch of numpy arrays, moved
    to the parameters' device. ``grad_fn(params, batch) -> (loss, grads)``
    defaults to ``lm_loss`` differentiated by ``torch.autograd.grad``."""

    def __init__(self, scheduler, cfg, tc: TrainConfig, state: dict,
                 batch_fn: Callable[[int], dict], *, step_time: float = 10.0,
                 grad_fn: Callable | None = None):
        self.scheduler = scheduler
        self.cfg = cfg
        self.tc = tc
        self.state = state
        self.batch_fn = batch_fn
        self.step_time = step_time
        self.topic = Topic("elastic-shards", scheduler)
        self.applied: set[tuple[int, int]] = set()
        self.losses: list[float] = []
        self.workers: dict[str, Worker] = {}
        self._grad = grad_fn or (lambda p, b: loss_and_grads(p, cfg, b))
        self._device = state["opt"]["count"].device
        self._backlog: list = []
        self.sub = Subscription(self.topic, "trainers", self._on_shard,
                                ack_deadline=step_time * 6,
                                max_outstanding=64, min_backoff=1.0)

    # ---- fleet management -------------------------------------------------
    def add_worker(self, name: str, speed: float = 1.0) -> Worker:
        w = Worker(name, speed)
        self.workers[name] = w
        self.scheduler.schedule(0.0, self._pump)
        return w

    def kill_worker(self, name: str):
        if name in self.workers:
            self.workers[name].alive = False

    def _idle_workers(self):
        return [w for w in self.workers.values() if w.alive]

    # ---- shard flow ---------------------------------------------------------
    def publish_epoch(self, n_shards: int, epoch: int = 0):
        for s in range(n_shards):
            self.topic.publish({"shard": s, "epoch": epoch})

    def _on_shard(self, msg, ctx):
        self._backlog.append((msg.data, ctx))
        self._pump()

    def _pump(self):
        while self._backlog and self._idle_workers():
            data, ctx = self._backlog.pop(0)
            worker = self._idle_workers()[0]
            # worker "computes" for step_time/speed sim-seconds, then applies
            self.scheduler.schedule(
                self.step_time / worker.speed, self._finish, worker, data, ctx
            )

    def _finish(self, worker: Worker, data: dict, ctx):
        if not worker.alive:
            return  # died mid-step: no ack → redelivery
        key = (data["epoch"], data["shard"])
        if key in self.applied:  # duplicate after redelivery: effectively-once
            ctx.ack()
            return
        batch = {k: torch.as_tensor(v, device=self._device) for k, v in
                 self.batch_fn(data["shard"]).items()}
        loss, grads = self._grad(self.state["params"], batch)
        params, opt, _ = adamw_update(self.tc, self.state["params"], grads,
                                      self.state["opt"])
        self.state["params"], self.state["opt"] = params, opt
        self.applied.add(key)
        self.losses.append(float(loss))
        ctx.ack()
        self._pump()

    # ---- epochs ---------------------------------------------------------------
    def run_epoch(self, n_shards: int, epoch: int = 0,
                  chaos: Callable | None = None):
        """Publish an epoch and drain it; ``chaos(t, trainer)`` may be
        scheduled by the caller beforehand for fault injection."""
        self.publish_epoch(n_shards, epoch)
        self.scheduler.run(max_events=1_000_000)
        return sorted(s for e, s in self.applied if e == epoch)
