"""Serving-step builders (prefill / decode), a copy of
``repro.serve.steps``: the steps the dry run counts (``launch.dryrun``)
and the engine runs (``serve.engine``).

:class:`DecodeGraph` is the port's counterpart of the reference engine's
``jax.jit`` of its decode step: the step's own kernels captured once in
a CUDA graph over a fixed cache and replayed with one launch a tick.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.params import ParamDef, tree_defs

__all__ = ["make_prefill_step", "make_decode_step", "decode_input_defs",
           "prefill_input_defs", "DecodeGraph", "leaf_ids", "check_leaves"]


def make_prefill_step(cfg, max_len: int | None = None):
    """step(params, tokens[, cond]) -> (last_logits, cache)."""

    if cfg.family in ("vlm", "audio"):
        def step(params, tokens, cond):
            return M.prefill(params, cfg, tokens, cond=cond, max_len=max_len)
    else:
        def step(params, tokens):
            return M.prefill(params, cfg, tokens, max_len=max_len)
    return step


def make_decode_step(cfg):
    """step(params, cache, token, pos) -> (logits, cache); the cache is
    written in place (``M.decode_step``)."""

    def step(params, cache, token, pos):
        return M.decode_step(params, cfg, cache, token, pos)

    return step


def prefill_input_defs(cfg, batch: int, seq_len: int) -> dict:
    d = {"tokens": ParamDef((batch, seq_len), ("batch", "seq"),
                            dtype=torch.int32)}
    if cfg.family in ("vlm", "audio"):
        d["cond"] = ParamDef(
            (batch, cfg.n_cross_tokens, cfg.d_model), ("batch", "", "embed"),
            dtype=cfg.dtype,
        )
    return d


def decode_input_defs(cfg, batch: int) -> dict:
    return {
        "token": ParamDef((batch, 1), ("batch", ""), dtype=torch.int32),
        "pos": ParamDef((batch,), ("batch",), dtype=torch.int32),
    }


def leaf_ids(params, cache) -> dict:
    """``(data_ptr, dtype, shape)`` of every tensor of ``params`` and
    ``cache``, by its path (``params/...``, ``cache/...``): what a graph
    captured over them reads and writes."""
    return {"/".join((root,) + path): (t.data_ptr(), t.dtype,
                                       tuple(t.shape))
            for root, tree in (("params", params), ("cache", cache))
            for path, t in tree_defs(tree)}


def check_leaves(want: dict, params, cache) -> None:
    """Raise ``RuntimeError`` naming the first leaf of ``params`` or
    ``cache`` whose storage, dtype or shape is not ``want``'s
    (:func:`leaf_ids`), or that was added or removed."""
    live = leaf_ids(params, cache)
    for path in sorted(want.keys() | live.keys()):
        if want.get(path) != live.get(path):
            raise RuntimeError(
                f"decode graph: leaf {path} changed since the capture "
                f"({want.get(path)} -> {live.get(path)}); the graph reads "
                "and writes the captured storage only")


class DecodeGraph:
    """``step(params, cache, token, pos)`` captured once as a CUDA graph.

    The inputs are static buffers on the cache's card: ``token`` (B, 1)
    int64 and ``pos`` (B,) int32, the dtypes the eager tick passes; the
    step's logits (B, V) are the graph's static output, overwritten by
    the next replay. The capture records the step's kernels and runs none
    of them, so the cache is not advanced by it; the caller must have run
    the step eagerly at least once before (cuBLAS handles, the
    allocator's pools, and a float32 model's bf16 state leaves replaced:
    ``M.decode_step``'s contract). The capture uses the default global
    capture mode: CUDA work from another thread during it fails the
    capture, which raises.

    ``__call__(token, pos)`` copies host arrays into the static buffers,
    checks that every leaf of ``params`` and ``cache`` is the tensor the
    graph captured (:func:`check_leaves`; ``RuntimeError`` otherwise),
    replays and returns the static logits. ``captured_launches`` is the
    ``kernels.ops`` launches counted during the capture (a replay counts
    none); ``replays`` counts replays.
    """

    def __init__(self, step, params, cache, batch: int):
        dev = next(t for _, t in tree_defs(cache)).device
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph: the cache is on {dev}, a CUDA "
                             "graph needs a CUDA device")
        self.params, self.cache = params, cache
        self.token = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.leaves = leaf_ids(params, cache)
        self.graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(self.graph):
            self.logits, out = step(params, cache, self.token, self.pos)
        after = ops.launch_counts()
        self.captured_launches = sum(after[k] - before[k] for k in after)
        if out is not cache:
            raise RuntimeError("decode graph: the step returned another "
                               "cache than it was given")
        check_leaves(self.leaves, params, cache)
        self.replays = 0

    def __call__(self, token, pos) -> torch.Tensor:
        check_leaves(self.leaves, self.params, self.cache)
        self.token.copy_(torch.from_numpy(
            np.asarray(token).reshape(self.token.shape)))
        self.pos.copy_(torch.from_numpy(np.asarray(pos)))
        self.graph.replay()
        self.replays += 1
        return self.logits
