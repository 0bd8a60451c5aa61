"""Model assembly: the ``dense`` and ``ssm`` families of
``repro.models.model``.

* ``model_defs(cfg)``                — ParamDef tree (stacked layers)
* ``init_params(cfg, generator, device)``
* ``forward(params, cfg, tokens, mode="train"|"prefill")`` — full
  sequence; ``mode="prefill"`` also returns the per-layer K/V stacks
  (dense) or states (ssm)
* ``lm_loss(params, cfg, batch)``    — next-token cross-entropy
* ``cache_defs`` / ``init_cache``     — the decode state
* ``decode_step(params, cfg, cache, token, pos)`` — one serving step
* ``prefill(params, cfg, tokens, max_len=...)``   — prompt → cache

Families:
  dense — [norm→attn, norm→mlp], or the Cohere-style parallel block
  ssm   — rwkv6: time-mix + channel-mix

Layers are stored stacked (a leading ``layers`` axis on every leaf) as in
the reference and walked with a Python loop in place of ``lax.scan``.
``impl`` (``"auto"`` or ``"ref"``) goes to ``kernels.ops.wkv_chunk``, the
ssm prefill's one kernel; a function with its signature takes its place
(:func:`rwkv6.rwkv_block`). The dense family runs no kernel of its own.
The moe, hybrid, vlm and audio families raise ``NotImplementedError``:
they come with ROADMAP A9.
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
    "active_param_count",
    "forward",
    "lm_loss",
    "cache_defs",
    "init_cache",
    "decode_step",
    "prefill",
]

_PORTED = ("dense", "ssm")


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"runs the {' and '.join(_PORTED)} families, the others come "
            "with ROADMAP A9")


def _stack(defs, n: int):
    """Add a leading stacked-layers axis to every ParamDef in a tree."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=("layers",) + d.logical), defs)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), ("embed",), init="ones")


def _dense_layer_defs(cfg) -> dict:
    d = {"norm1": _norm_def(cfg), "attn": lyr.attn_defs(cfg),
         "mlp": lyr.mlp_defs(cfg)}
    if not cfg.parallel_block:
        d["norm2"] = _norm_def(cfg)
    return d


def model_defs(cfg) -> dict:
    _check_family(cfg)
    layer = _dense_layer_defs(cfg) if cfg.family == "dense" else \
        rwkv.rwkv_defs(cfg)
    return {"embed": lyr.embed_defs(cfg), "final_norm": _norm_def(cfg),
            "layers": _stack(layer, cfg.num_layers)}


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters by the reference's init rules, drawn from
    ``generator`` (on ``device``)."""
    return materialize(model_defs(cfg), generator, device)


def param_count(cfg) -> int:
    return count_params(model_defs(cfg))


def active_param_count(cfg) -> int:
    """Params touched per token: all of them in the dense and ssm families
    (the moe family's top-k of E experts comes with it)."""
    return param_count(cfg)


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------
def _apply_dense(pl, cfg, x, positions):
    h = lyr.rms_norm(x, pl["norm1"], cfg.norm_eps)
    attn_out, kv = lyr.self_attention(pl["attn"], cfg, h, positions,
                                      window=cfg.sliding_window)
    if cfg.parallel_block:
        x = x + attn_out + lyr.mlp_apply(pl["mlp"], cfg, h)
    else:
        x = x + attn_out
        h2 = lyr.rms_norm(x, pl["norm2"], cfg.norm_eps)
        x = x + lyr.mlp_apply(pl["mlp"], cfg, h2)
    return x, kv


def forward(params, cfg, tokens, *, mode: str = "train",
            impl: str = "auto"):
    """tokens: (B, S) int. Returns (hidden (B, S, D), aux_loss, cache_parts)
    where cache_parts holds, when ``mode == "prefill"``, the per-layer K/V
    (``k``, ``v``: (L, B, S, KV, hd)) of the dense family or the states
    (``rwkv``) of the ssm family, stacked; else {}. (The conditioning
    stream ``cond`` of the vlm and audio families comes with them.)
    """
    _check_family(cfg)
    B, S = tokens.shape
    want = mode == "prefill"
    x = lyr.embed_apply(params["embed"], cfg, tokens)
    parts = {}
    if cfg.family == "dense":
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = _apply_dense(_layer(params["layers"], i), cfg, x,
                                     positions)
            if want:
                ks.append(k)
                vs.append(v)
        if want:
            parts["k"], parts["v"] = torch.stack(ks), torch.stack(vs)
    else:
        states = []
        for i in range(cfg.num_layers):
            x, st = rwkv.rwkv_block(_layer(params["layers"], i), cfg, x,
                                    impl=impl)
            if want:
                states.append(st)
        if want:
            parts["rwkv"] = tree_map(lambda *xs: torch.stack(xs), *states)
    x = lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), parts


def lm_loss(params, cfg, batch, *, impl: str = "auto"):
    """batch: {"tokens": (B, S), "labels": (B, S)}."""
    x, aux, _ = forward(params, cfg, batch["tokens"], mode="train",
                        impl=impl)
    loss = lyr.softmax_xent_chunked(params["embed"], cfg, x, batch["labels"])
    return loss + 0.01 * aux


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------
def _kv_int8(cfg) -> bool:
    return cfg.kv_cache_dtype == "int8"


def _kv_cache_def(cfg, n_layers, batch, W):
    dtype = torch.int8 if _kv_int8(cfg) else cfg.dtype
    return ParamDef((n_layers, batch, W, cfg.num_kv_heads, cfg.head_dim),
                    ("layers", "batch", "kvseq", "heads", "head_dim"),
                    dtype=dtype, init="zeros")


def _kv_scale_def(cfg, n_layers, batch, W):
    return ParamDef((n_layers, batch, W, cfg.num_kv_heads),
                    ("layers", "batch", "kvseq", "heads"),
                    dtype=torch.float32, init="zeros")


def _window(cfg, max_len: int) -> int:
    """The KV cache's length: ``max_len``, capped by a sliding window
    (a rolling buffer)."""
    win = cfg.sliding_window
    return min(max_len, win) if win else max_len


def cache_defs(cfg, batch: int, max_len: int) -> dict:
    """Decode-state ParamDef tree. ``max_len`` is the KV window the serving
    shape demands; SWA archs cap it at their window (rolling buffer). The
    ssm family's state does not grow with the sequence: ``max_len`` only
    bounds the engine's positions there."""
    _check_family(cfg)
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"rwkv": _stack(rwkv.rwkv_state_defs(cfg, batch), L)}
    W = _window(cfg, max_len)
    d = {"k": _kv_cache_def(cfg, L, batch, W),
         "v": _kv_cache_def(cfg, L, batch, W),
         "kv_pos": ParamDef((batch, W), ("batch", "kvseq"),
                            dtype=torch.int32, init="unwritten")}
    if _kv_int8(cfg):
        d["k_scale"] = _kv_scale_def(cfg, L, batch, W)
        d["v_scale"] = _kv_scale_def(cfg, L, batch, W)
    return d


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Materialized zero cache (``kv_pos`` slots marked ``UNWRITTEN``)."""
    return materialize(cache_defs(cfg, batch, max_len), None, device)


# --------------------------------------------------------------------------
# one-token decode
# --------------------------------------------------------------------------
def decode_step(params, cfg, cache, token, pos):
    """token: (B, 1) int; pos: (B,) int. Returns (logits (B, V), cache).

    The step writes its state into ``cache`` and returns that same dict:
    the dense family's new K/V (and int8 scales) and ``kv_pos``, the ssm
    family's states, each into its tensor in place (a copy of the KV cache
    would move all of it every step). A caller that needs the old cache
    clones it first. The one exception is a dtype the reference's scan
    changes: an ssm model computing in float32 returns float32 token
    shifts where the store is bf16, so on its first step those leaves are
    replaced in the dict by float32 ones and written in place from then on.
    """
    _check_family(cfg)
    x = lyr.embed_apply(params["embed"], cfg, token)
    if cfg.family == "dense":
        win = cfg.sliding_window
        kv_pos = lyr.write_kv_pos(cache["kv_pos"], pos, window=win)
        int8 = _kv_int8(cfg)
        for i in range(cfg.num_layers):
            pl = _layer(params["layers"], i)
            h = lyr.rms_norm(x, pl["norm1"], cfg.norm_eps)
            a = lyr.decode_self_attention(
                pl["attn"], cfg, h, cache["k"][i], cache["v"][i], kv_pos, pos,
                window=win,
                k_scale=cache["k_scale"][i] if int8 else None,
                v_scale=cache["v_scale"][i] if int8 else None)[0]
            if cfg.parallel_block:
                x = x + a + lyr.mlp_apply(pl["mlp"], cfg, h)
            else:
                x = x + a
                h2 = lyr.rms_norm(x, pl["norm2"], cfg.norm_eps)
                x = x + lyr.mlp_apply(pl["mlp"], cfg, h2)
    else:
        state, states = cache["rwkv"], []
        for i in range(cfg.num_layers):
            x, st = rwkv.rwkv_block_decode(_layer(params["layers"], i), cfg,
                                           x, _layer(state, i))
            states.append(st)
        for key, buf in state.items():  # one stacked write a leaf
            new = [st[key] for st in states]
            # the states keep the dtype they were computed in, as the
            # reference's scan does (the token shifts leave bf16 when the
            # model runs in f32)
            if buf.dtype == new[0].dtype:
                torch.stack(new, out=buf)
            else:
                state[key] = torch.stack(new)
    x = lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lyr.logits_apply(params["embed"], cfg, x)[:, 0]
    return logits, cache


# --------------------------------------------------------------------------
# prefill → cache
# --------------------------------------------------------------------------
def prefill(params, cfg, tokens, *, max_len: int | None = None,
            impl: str = "auto"):
    """Run the full prompt and build a decode cache of size ``max_len``.

    Returns (last_token_logits (B, V), cache). The dense cache holds the
    last ``min(S, W)`` positions; under a sliding window shorter than the
    prompt they lie in the rolling buffer's order (position p at slot
    p % W), and with ``+kv8`` they are quantized as decode quantizes them.
    """
    B, S = tokens.shape
    max_len = max_len or S
    x, _, parts = forward(params, cfg, tokens, mode="prefill", impl=impl)
    cache = init_cache(cfg, B, max_len, x.device)
    if cfg.family == "ssm":
        cache["rwkv"] = tree_map(lambda dst, src: src.to(dst.dtype),
                                 cache["rwkv"], parts["rwkv"])
    else:
        W = _window(cfg, max_len)
        keep = min(S, W)
        pos_tail = torch.arange(S - keep, S, dtype=torch.int32,
                                device=x.device)
        order = None
        if cfg.sliding_window and S > W:
            # rolling buffer: slot of absolute position p is p % W
            order = torch.argsort(pos_tail % W)
            pos_tail = pos_tail[order]
        for side in ("k", "v"):
            # (L, B, S, KV, hd) → the last `keep` positions, slot-ordered
            src = parts[side][:, :, S - keep:]
            if order is not None:
                src = src[:, :, order]
            if _kv_int8(cfg):
                q, scale = lyr.quantize_kv(src)
                cache[side][:, :, :keep] = q
                cache[side + "_scale"][:, :, :keep] = scale
            else:
                cache[side][:, :, :keep] = src.to(cache[side].dtype)
        cache["kv_pos"][:, :keep] = pos_tail[None]
    logits = lyr.logits_apply(params["embed"], cfg, x[:, -1:])[:, 0]
    return logits, cache
