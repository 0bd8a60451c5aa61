"""Model assembly: the ``ssm`` family (RWKV6) of ``repro.models.model``.

* ``model_defs(cfg)``                — ParamDef tree (stacked layers)
* ``init_params(cfg, generator, device)``
* ``forward(params, cfg, tokens, mode="train"|"prefill")`` — full
  sequence; ``mode="prefill"`` also returns the per-layer states
* ``cache_defs`` / ``init_cache``     — the decode state
* ``decode_step(params, cfg, cache, token, pos)`` — one serving step
* ``prefill(params, cfg, tokens, max_len=...)``   — prompt → cache

Layers are stored stacked (a leading ``layers`` axis on every leaf) as in
the reference and walked with a Python loop in place of ``lax.scan``.
``impl`` (``"auto"`` or ``"ref"``) goes to ``kernels.ops.wkv_chunk``, the
prefill's one kernel; a function with its signature takes its place
(:func:`rwkv6.rwkv_block`). The other families (dense, moe, audio, vlm, hybrid)
raise ``NotImplementedError``: they come with ROADMAP A9.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as lyr
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.params import (ParamDef, count_params, materialize,
                                       tree_map)

__all__ = [
    "model_defs",
    "init_params",
    "param_count",
    "forward",
    "cache_defs",
    "init_cache",
    "decode_step",
    "prefill",
]


def _check_family(cfg) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            "runs the ssm family (rwkv6) only, the others come with ROADMAP "
            "A9")


def _stack(defs, n: int):
    """Add a leading stacked-layers axis to every ParamDef in a tree."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=("layers",) + d.logical), defs)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), ("embed",), init="ones")


def model_defs(cfg) -> dict:
    _check_family(cfg)
    return {"embed": lyr.embed_defs(cfg), "final_norm": _norm_def(cfg),
            "layers": _stack(rwkv.rwkv_defs(cfg), cfg.num_layers)}


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters by the reference's init rules, drawn from
    ``generator`` (on ``device``)."""
    return materialize(model_defs(cfg), generator, device)


def param_count(cfg) -> int:
    return count_params(model_defs(cfg))


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------
def forward(params, cfg, tokens, *, mode: str = "train",
            impl: str = "auto"):
    """tokens: (B, S) int. Returns (hidden (B, S, D), aux_loss, cache_parts)
    where cache_parts holds the per-layer states (stacked) when
    ``mode == "prefill"``, else {}. (The conditioning stream ``cond`` of
    the vlm and audio families comes with them.)
    """
    _check_family(cfg)
    x = lyr.embed_apply(params["embed"], cfg, tokens)
    states = []
    for i in range(cfg.num_layers):
        x, st = rwkv.rwkv_block(_layer(params["layers"], i), cfg, x,
                                impl=impl)
        if mode == "prefill":
            states.append(st)
    parts = {}
    if states:
        parts["rwkv"] = tree_map(lambda *xs: torch.stack(xs), *states)
    x = lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), parts


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------
def cache_defs(cfg, batch: int, max_len: int) -> dict:
    """Decode-state ParamDef tree. The ssm family's state does not grow
    with the sequence: ``max_len`` only bounds the engine's positions."""
    _check_family(cfg)
    return {"rwkv": _stack(rwkv.rwkv_state_defs(cfg, batch), cfg.num_layers)}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Materialized zero cache."""
    return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                          device=device),
                    cache_defs(cfg, batch, max_len))


# --------------------------------------------------------------------------
# one-token decode
# --------------------------------------------------------------------------
def decode_step(params, cfg, cache, token, pos):
    """token: (B, 1) int; pos: (B,) int. Returns (logits (B, V), cache).

    The input cache is not modified: the returned one is new.
    """
    _check_family(cfg)
    x = lyr.embed_apply(params["embed"], cfg, token)
    states = []
    for i in range(cfg.num_layers):
        x, st = rwkv.rwkv_block_decode(_layer(params["layers"], i), cfg, x,
                                       _layer(cache["rwkv"], i))
        states.append(st)
    new_cache = dict(cache)
    # the states keep the dtype they were computed in, as the reference's
    # scan does (the token shifts leave bf16 when the model runs in f32)
    new_cache["rwkv"] = tree_map(lambda *xs: torch.stack(xs), *states)
    x = lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lyr.logits_apply(params["embed"], cfg, x)[:, 0]
    return logits, new_cache


# --------------------------------------------------------------------------
# prefill → cache
# --------------------------------------------------------------------------
def prefill(params, cfg, tokens, *, max_len: int | None = None,
            impl: str = "auto"):
    """Run the full prompt and build a decode cache of size ``max_len``.

    Returns (last_token_logits (B, V), cache).
    """
    B, S = tokens.shape
    max_len = max_len or S
    x, _, parts = forward(params, cfg, tokens, mode="prefill", impl=impl)
    cache = init_cache(cfg, B, max_len, x.device)
    cache["rwkv"] = tree_map(lambda dst, src: src.to(dst.dtype),
                             cache["rwkv"], parts["rwkv"])
    logits = lyr.logits_apply(params["embed"], cfg, x[:, -1:])[:, 0]
    return logits, cache
