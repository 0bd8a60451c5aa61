"""Training data pipeline, a copy of ``repro.data.pipeline``.

``TokenDataset`` — deterministic synthetic LM token stream: shard ``i`` of
``n`` is reproducible from (seed, shard) alone, so any worker can regenerate
any shard (the stateless-worker property the elastic trainer relies on).
A light Markov structure gives the loss something learnable.

``ShardQueue`` — the paper's pattern applied to training data: shards are
messages on a pub/sub topic; trainer workers are the subscribers. A worker
that dies mid-shard never acks, so the shard redelivers to a healthy worker
(at-least-once ⇒ no data loss on preemption); hedged redelivery doubles as
straggler mitigation. This is the job-level event-driven layer — inside a
training step everything stays synchronous SPMD.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenDataset", "make_lm_batch", "ShardQueue"]


class TokenDataset:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 order: int = 1):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        # a small deterministic Markov transition to make loss learnable
        rng = np.random.default_rng(seed)
        self._shift = rng.integers(1, vocab_size, size=64)

    def shard_batch(self, shard: int, batch: int) -> dict[str, np.ndarray]:
        """Batch for one shard id — stateless and reproducible."""
        rng = np.random.default_rng((self.seed << 20) ^ shard)
        S = self.seq_len
        toks = np.empty((batch, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        noise = rng.integers(0, self.vocab_size, size=(batch, S))
        use_noise = rng.random((batch, S)) < 0.15
        for t in range(S):
            step = self._shift[toks[:, t] % 64]
            nxt = (toks[:, t] + step) % self.vocab_size
            toks[:, t + 1] = np.where(use_noise[:, t], noise[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_lm_batch(cfg, batch: int, seq_len: int, *, shard: int = 0,
                  seed: int = 0) -> dict:
    ds = TokenDataset(cfg.vocab_size, seq_len, seed=seed)
    b = ds.shard_batch(shard, batch)
    if cfg.family in ("vlm", "audio"):
        rng = np.random.default_rng(seed + 1)
        b["cond"] = rng.normal(
            0, 1, size=(batch, cfg.n_cross_tokens, cfg.d_model)
        ).astype(np.float32)
    return b


class ShardQueue:
    """Data shards as pub/sub messages; at-least-once, idempotent by shard id."""

    def __init__(self, topic, name: str = "train-shards", *,
                 ack_deadline: float = 900.0, hedge_after: float | None = None):
        from repro_torch.core.pubsub import Subscription

        self.topic = topic
        self._pending: list[tuple[dict, object]] = []
        self.sub = Subscription(topic, name, self._on_msg,
                                ack_deadline=ack_deadline,
                                hedge_after=hedge_after)
        self.seen: set[int] = set()

    def publish_epoch(self, n_shards: int, epoch: int = 0):
        for s in range(n_shards):
            self.topic.publish({"shard": s, "epoch": epoch},
                               ordering_key=None)

    def _on_msg(self, msg, ctx):
        self._pending.append((msg.data, ctx))

    def poll(self):
        """Next (shard_dict, ack_fn) or None; duplicates are auto-acked."""
        while self._pending:
            data, ctx = self._pending.pop(0)
            key = (data["epoch"] << 32) | data["shard"]
            if key in self.seen:  # redelivered after we already trained on it
                ctx.ack()
                continue
            def ack(ctx=ctx, key=key):
                self.seen.add(key)
                ctx.ack()
            return data, ack
        return None
