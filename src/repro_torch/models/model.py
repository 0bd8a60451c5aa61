"""Model assembly for the architecture zoo, a copy of
``repro.models.model``.

* ``model_defs(cfg)``                — ParamDef tree (stacked layers)
* ``init_params(cfg, generator, device)``
* ``forward(params, cfg, tokens, cond=..., mode="train"|"prefill")`` —
  full sequence; ``mode="prefill"`` also returns the per-layer K/V stacks
  and states
* ``lm_loss(params, cfg, batch)``    — next-token cross-entropy (+ MoE aux)
* ``cache_defs`` / ``init_cache``     — the decode state
* ``abstract_params`` / ``abstract_cache`` — both as meta tensors
* ``decode_step(params, cfg, cache, token, pos)`` — one serving step
* ``prefill(params, cfg, tokens, cond=..., max_len=...)`` — prompt → cache

Families:
  dense  — [norm→attn, norm→mlp], or the Cohere-style parallel block
  moe    — attention + top-k expert FFN (SWA rolling KV)
  audio  — musicgen: self-attn + cross-attn (text cond) + mlp, every layer
  vlm    — llama-3.2-vision: a cross-attn block before every
           ``cross_attn_every``-th layer (``num_layers // cross_attn_every``
           blocks)
  hybrid — zamba2: Mamba2 backbone, a weight-shared attn+mlp block before
           each group of ``shared_attn_every`` Mamba layers
  ssm    — rwkv6: time-mix + channel-mix

Layers are stored stacked (a leading ``layers`` axis on every leaf) as in
the reference and walked with a Python loop in place of ``lax.scan``; the
full-sequence forward splits each stack once with ``torch.unbind``
(:func:`_unstack`), and under grad wraps each layer body in
``torch.utils.checkpoint`` by ``cfg.remat`` (:func:`_remat`, the
reference's ``_maybe_remat``).
``impl`` (``"auto"`` or ``"ref"``) goes to ``kernels.ops.wkv_chunk``, the
ssm prefill's one kernel; a function with its signature takes its place
(:func:`rwkv6.rwkv_block`). The other families run no kernel of their own
(``repro`` computes them outside any Pallas kernel). ``cond`` (B,
n_cross_tokens, d_model) is the vlm and audio families' conditioning
stream.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import sharding as shd
from repro_torch.models import layers as lyr
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.params import (UNWRITTEN, ParamDef, abstractify,
                                       count_params, materialize, tree_map)

__all__ = [
    "model_defs",
    "init_params",
    "abstract_params",
    "param_count",
    "active_param_count",
    "zamba_groups",
    "forward",
    "lm_loss",
    "cache_defs",
    "init_cache",
    "abstract_cache",
    "decode_step",
    "prefill",
]


def _stack(defs, n: int):
    """Add a leading stacked-layers axis to every ParamDef in a tree."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=("layers",) + d.logical), defs)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree (views, no copies).

    Each leaf is split once, by ``torch.unbind``, whose backward stacks the
    layers' gradients in one write. Slicing ``a[i]`` per layer would give
    each layer a ``SelectBackward`` that writes a zero-filled gradient of
    the whole stack, and autograd would sum ``n`` of them."""
    parts = tree_map(torch.unbind, tree)
    return [tree_map(lambda p: p[i], parts) for i in range(n)]


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), ("embed",), init="ones")


def _dense_layer_defs(cfg) -> dict:
    d = {"norm1": _norm_def(cfg), "attn": lyr.attn_defs(cfg),
         "mlp": lyr.mlp_defs(cfg)}
    if not cfg.parallel_block:
        d["norm2"] = _norm_def(cfg)
    return d


def _moe_layer_defs(cfg) -> dict:
    return {"norm1": _norm_def(cfg), "attn": lyr.attn_defs(cfg),
            "norm2": _norm_def(cfg), "moe": moe_mod.moe_defs(cfg)}


def _audio_layer_defs(cfg) -> dict:
    return {"norm1": _norm_def(cfg), "attn": lyr.attn_defs(cfg),
            "norm_x": _norm_def(cfg), "xattn": lyr.attn_defs(cfg),
            "norm2": _norm_def(cfg), "mlp": lyr.mlp_defs(cfg)}


def _cross_block_defs(cfg) -> dict:
    return {"norm_x": _norm_def(cfg), "xattn": lyr.attn_defs(cfg, cross=True)}


def zamba_groups(cfg) -> list[int]:
    """Mamba-layer counts between shared-block applications."""
    every, L, out = cfg.shared_attn_every, cfg.num_layers, []
    while L > 0:
        out.append(min(every, L))
        L -= every
    return out


def _n_cross(cfg) -> int:
    """The vlm family's cross blocks (one before every ``cross_attn_every``-th
    layer, from layer 0)."""
    return cfg.num_layers // cfg.cross_attn_every


def model_defs(cfg) -> dict:
    d = {"embed": lyr.embed_defs(cfg), "final_norm": _norm_def(cfg)}
    fam, L = cfg.family, cfg.num_layers
    if fam == "dense":
        d["layers"] = _stack(_dense_layer_defs(cfg), L)
    elif fam == "moe":
        d["layers"] = _stack(_moe_layer_defs(cfg), L)
    elif fam == "audio":
        d["layers"] = _stack(_audio_layer_defs(cfg), L)
    elif fam == "vlm":
        d["layers"] = _stack(_dense_layer_defs(cfg), L)
        d["cross"] = _stack(_cross_block_defs(cfg), _n_cross(cfg))
    elif fam == "hybrid":
        d["layers"] = _stack(mb.mamba2_defs(cfg), L)
        d["shared"] = {"norm1": _norm_def(cfg), "attn": lyr.attn_defs(cfg),
                       "norm2": _norm_def(cfg), "mlp": lyr.mlp_defs(cfg)}
    elif fam == "ssm":
        d["layers"] = _stack(rwkv.rwkv_defs(cfg), L)
    else:
        raise ValueError(f"unknown family {fam!r}")
    return d


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters by the reference's init rules, drawn from
    ``generator`` (on ``device``)."""
    return materialize(model_defs(cfg), generator, device)


def abstract_params(cfg):
    """The parameters as meta tensors (``params.abstractify``)."""
    return abstractify(model_defs(cfg))


def param_count(cfg) -> int:
    return count_params(model_defs(cfg))


def active_param_count(cfg) -> int:
    """Params touched per token (MoE: top-k of E experts)."""
    n = param_count(cfg)
    if cfg.num_experts:
        expert = 3 * cfg.d_model * cfg.d_ff  # wg, wu, wd
        n -= cfg.num_layers * (cfg.num_experts - cfg.num_experts_per_tok) \
            * expert
    return n


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmul outputs, recompute the rest (the
    counterpart of ``checkpoint_dots_with_no_batch_dims``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` (a layer body) under ``cfg.remat`` when grad is on: ``"none"``
    keeps every activation, ``"dots"`` the matmul outputs, anything else
    (``"nothing"``, the default) recomputes the whole body in the
    backward, as the reference's ``_maybe_remat``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


# --------------------------------------------------------------------------
# layer bodies (full sequence)
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


def _apply_moe(pl, cfg, x, positions):
    h = lyr.rms_norm(x, pl["norm1"], cfg.norm_eps)
    attn_out, kv = lyr.self_attention(pl["attn"], cfg, h, positions,
                                      window=cfg.sliding_window)
    x = x + attn_out
    h2 = lyr.rms_norm(x, pl["norm2"], cfg.norm_eps)
    moe_out, aux = moe_mod.moe_apply(pl["moe"], cfg, h2)
    return x + moe_out, kv, aux


def _apply_cross(pl, cfg, x, cond):
    """Cross-attention sub-block; K/V computed from the conditioning stream."""
    h = lyr.rms_norm(x, pl["norm_x"], cfg.norm_eps)
    k, v = lyr.attn_project_kv(pl["xattn"], cfg, cond, None, rope=False)
    out = lyr.cross_attention(pl["xattn"], cfg, h, (k, v))
    return x + out, (k, v)


def _apply_audio(pl, cfg, x, positions, cond):
    h = lyr.rms_norm(x, pl["norm1"], cfg.norm_eps)
    attn_out, kv = lyr.self_attention(pl["attn"], cfg, h, positions)
    x = x + attn_out
    x, xkv = _apply_cross(pl, cfg, x, cond)
    h2 = lyr.rms_norm(x, pl["norm2"], cfg.norm_eps)
    x = x + lyr.mlp_apply(pl["mlp"], cfg, h2)
    return x, kv, xkv


def _apply_shared(ps, cfg, x, positions):
    """Zamba2 weight-shared attention+MLP block."""
    h = lyr.rms_norm(x, ps["norm1"], cfg.norm_eps)
    attn_out, kv = lyr.self_attention(ps["attn"], cfg, h, positions)
    x = x + attn_out
    h2 = lyr.rms_norm(x, ps["norm2"], cfg.norm_eps)
    return x + lyr.mlp_apply(ps["mlp"], cfg, h2), kv


def _apply_mamba(pl, cfg, x, want: bool):
    """One Mamba2 layer of the hybrid with its residual."""
    h = lyr.rms_norm(x, pl["norm"], cfg.norm_eps)
    out, st = mb.mamba2_apply(pl, cfg, h, return_state=want)
    return x + out, st


def _stacked(items):
    """A list of per-layer trees → one tree of stacked leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *items)


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------
def forward(params, cfg, tokens, *, cond=None, mode: str = "train",
            impl: str = "auto"):
    """tokens: (B, S) int; cond: (B, n_cross_tokens, D) for vlm/audio.

    Returns (hidden (B, S, D), aux_loss, cache_parts) where cache_parts
    holds, when ``mode == "prefill"``, the per-layer stacks a decode cache
    is built from (``k``/``v`` (L, B, S, KV, hd), ``cross_k``/``cross_v``,
    ``shared_k``/``shared_v``, the ``mamba`` or ``rwkv`` states); else {}.
    ``aux_loss`` sums the moe layers' load-balance losses (0 elsewhere).
    """
    B, S = tokens.shape
    want = mode == "prefill"
    fam = cfg.family
    if fam in ("vlm", "audio") and cond is None:
        raise ValueError(f"{cfg.name}: the {fam} family needs cond "
                         "(B, n_cross_tokens, d_model)")
    x = lyr.embed_apply(params["embed"], cfg, tokens)
    # (1, S): RoPE's angles are the same for every row, so none is made
    # per row (under a mesh a plain tensor is whole on every rank)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    parts: dict = {}
    kvs, xkvs, states = [], [], []

    layers = _unstack(params["layers"], cfg.num_layers)
    if fam in ("dense", "vlm", "moe", "audio"):
        every = cfg.cross_attn_every if fam == "vlm" else 0
        cross = _unstack(params["cross"], _n_cross(cfg)) if every else []
        for i, pl in enumerate(layers):
            if every and i % every == 0 and i // every < len(cross):
                x, xkv = _remat(_apply_cross, cfg)(cross[i // every], cfg,
                                                    x, cond)
                if want:
                    xkvs.append(xkv)
            if fam == "moe":
                x, kv, a = _remat(_apply_moe, cfg)(pl, cfg, x, positions)
                aux = aux + a
            elif fam == "audio":
                x, kv, xkv = _remat(_apply_audio, cfg)(pl, cfg, x,
                                                       positions, cond)
                if want:
                    xkvs.append(xkv)
            else:
                x, kv = _remat(_apply_dense, cfg)(pl, cfg, x, positions)
            if want:
                kvs.append(kv)
    elif fam == "hybrid":
        start, skvs = 0, []
        for cnt in zamba_groups(cfg):
            x, kv = _remat(_apply_shared, cfg)(params["shared"], cfg, x,
                                               positions)
            if want:
                skvs.append(kv)
            for pl in layers[start:start + cnt]:
                x, st = _remat(_apply_mamba, cfg)(pl, cfg, x, want)
                if want:
                    states.append(st)
            start += cnt
        if want:
            parts["shared_k"] = torch.stack([k for k, _ in skvs])
            parts["shared_v"] = torch.stack([v for _, v in skvs])
            parts["mamba"] = _stacked(states)
    elif fam == "ssm":
        block = partial(rwkv.rwkv_block, impl=impl)
        for pl in layers:
            x, st = _remat(block, cfg)(pl, cfg, x)
            if want:
                states.append(st)
        if want:
            parts["rwkv"] = _stacked(states)
    else:
        raise ValueError(f"unknown family {fam!r}")

    if kvs:
        parts["k"] = torch.stack([k for k, _ in kvs])
        parts["v"] = torch.stack([v for _, v in kvs])
    if xkvs:
        parts["cross_k"] = torch.stack([k for k, _ in xkvs])
        parts["cross_v"] = torch.stack([v for _, v in xkvs])
    x = lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, parts


def lm_loss(params, cfg, batch, *, impl: str = "auto"):
    """batch: {"tokens": (B, S), "labels": (B, S)[, "cond": (B, n, D)]}.
    The loss head runs in a ``record_function("xent")`` range."""
    x, aux, _ = forward(params, cfg, batch["tokens"], cond=batch.get("cond"),
                        mode="train", impl=impl)
    with torch.profiler.record_function("xent"):
        loss = lyr.softmax_xent_chunked(params["embed"], cfg, x,
                                        batch["labels"])
    return loss + 0.01 * aux


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------
def _kv_int8(cfg) -> bool:
    return cfg.kv_cache_dtype == "int8"


def _kv_cache_def(cfg, n_layers, batch, W, *, quantizable: bool = True):
    dtype = torch.int8 if (quantizable and _kv_int8(cfg)) else cfg.dtype
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
    bounds the engine's positions there. The cross K/V of vlm and audio
    stay in the compute dtype under ``+kv8`` (small, computed once per
    request); the hybrid's shared-block cache has no int8 form (ROADMAP
    F12), so an int8 hybrid config is refused."""
    fam, L = cfg.family, cfg.num_layers
    W = _window(cfg, max_len)
    kv_pos = ParamDef((batch, W), ("batch", "kvseq"), dtype=torch.int32,
                      init="unwritten")
    d: dict = {}
    if fam in ("dense", "moe", "audio", "vlm"):
        d["k"] = _kv_cache_def(cfg, L, batch, W)
        d["v"] = _kv_cache_def(cfg, L, batch, W)
        d["kv_pos"] = kv_pos
        if _kv_int8(cfg):
            d["k_scale"] = _kv_scale_def(cfg, L, batch, W)
            d["v_scale"] = _kv_scale_def(cfg, L, batch, W)
    if fam in ("audio", "vlm"):
        nx = L if cfg.cross_attn_all_layers else _n_cross(cfg)
        for side in ("cross_k", "cross_v"):
            d[side] = _kv_cache_def(cfg, nx, batch, cfg.n_cross_tokens,
                                    quantizable=False)
    if fam == "hybrid":
        if _kv_int8(cfg):
            raise ValueError(f"{cfg.name}: the hybrid family has no scaled "
                             "int8 KV cache (ROADMAP F12)")
        d["mamba"] = _stack(mb.mamba2_state_defs(cfg, batch), L)
        ns = len(zamba_groups(cfg))
        d["shared_k"] = _kv_cache_def(cfg, ns, batch, W)
        d["shared_v"] = _kv_cache_def(cfg, ns, batch, W)
        d["kv_pos"] = kv_pos
    if fam == "ssm":
        d["rwkv"] = _stack(rwkv.rwkv_state_defs(cfg, batch), L)
    return d


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Materialized zero cache (``kv_pos`` slots marked ``UNWRITTEN``);
    under a mesh, DTensors of the policy's placements
    (``sharding.placed``)."""
    defs = cache_defs(cfg, batch, max_len)
    mesh = shd.current_mesh()
    if mesh is None or mesh.size() == 1:
        return materialize(defs, None, device)

    def make(d):
        fill = UNWRITTEN if d.init == "unwritten" else 0
        return shd.placed(d, lambda shape, dtype, dev: torch.full(
            shape, fill, dtype=dtype, device=dev), device)
    return tree_map(make, defs)


def abstract_cache(cfg, batch: int, max_len: int):
    """The decode cache as meta tensors (``params.abstractify``)."""
    return abstractify(cache_defs(cfg, batch, max_len))


# --------------------------------------------------------------------------
# one-token decode
# --------------------------------------------------------------------------
def _store_states(store: dict, states: list) -> None:
    """Write a list of per-layer state dicts into the stacked ``store``,
    one stacked write a leaf, in place. A leaf whose step returns another
    dtype than it is stored in (the reference's scan keeps the computed
    dtype: bf16 token shifts or conv tails leave bf16 when the model runs
    in float32) is replaced in ``store`` by the computed one."""
    for key, buf in store.items():
        new = [st[key] for st in states]
        if buf.dtype == new[0].dtype and hasattr(buf, "to_local"):
            buf.copy_(torch.stack(new))  # a DTensor has no stack(out=)
        elif buf.dtype == new[0].dtype:
            torch.stack(new, out=buf)
        else:
            store[key] = torch.stack(new)


def _decode_self(pl, cfg, x, cache, i: int, kv_pos, pos, window: int = 0):
    """Self-attention of layer ``i`` against the K/V cache, written in
    place."""
    int8 = _kv_int8(cfg)
    h = lyr.rms_norm(x, pl["norm1"], cfg.norm_eps)
    a = lyr.decode_self_attention(
        pl["attn"], cfg, h, cache["k"][i], cache["v"][i], kv_pos, pos,
        window=window,
        k_scale=cache["k_scale"][i] if int8 else None,
        v_scale=cache["v_scale"][i] if int8 else None)[0]
    return h, a


def _cross_cached(pc, cfg, x, cache, j: int):
    """Cross-attention sub-block ``pc`` against cross K/V ``j`` of the
    cache, with its residual."""
    h = lyr.rms_norm(x, pc["norm_x"], cfg.norm_eps)
    return x + lyr.cross_attention(pc["xattn"], cfg, h,
                                   (cache["cross_k"][j], cache["cross_v"][j]))


def decode_step(params, cfg, cache, token, pos):
    """token: (B, 1) int; pos: (B,) int. Returns (logits (B, V), cache).

    The step writes its state into ``cache`` and returns that same dict:
    new K/V (and int8 scales), ``kv_pos`` and the ssm and Mamba2 states,
    each into its tensor in place (a copy of the KV cache would move all
    of it every step). A caller that needs the old cache clones it first.
    The one exception is a dtype the reference's scan changes: a model
    computing in float32 returns float32 RWKV token shifts and Mamba2 conv
    tails where the store is bf16, so on its first step those leaves are
    replaced in the dict by float32 ones and written in place from then on.
    """
    fam, L = cfg.family, cfg.num_layers
    x = lyr.embed_apply(params["embed"], cfg, token)
    win = cfg.sliding_window
    kv_pos = lyr.write_kv_pos(cache["kv_pos"], pos, window=win) \
        if "kv_pos" in cache else None

    if fam in ("dense", "moe", "vlm", "audio"):
        every = cfg.cross_attn_every if fam == "vlm" else 0
        for i in range(L):
            pl = _layer(params["layers"], i)
            if every and i % every == 0 and i // every < _n_cross(cfg):
                x = _cross_cached(_layer(params["cross"], i // every), cfg,
                                  x, cache, i // every)
            h, a = _decode_self(pl, cfg, x, cache, i, kv_pos, pos,
                                win if fam in ("dense", "moe") else 0)
            if fam == "dense" and cfg.parallel_block:
                x = x + a + lyr.mlp_apply(pl["mlp"], cfg, h)
                continue
            x = x + a
            if fam == "audio":
                x = _cross_cached(pl, cfg, x, cache, i)
            h2 = lyr.rms_norm(x, pl["norm2"], cfg.norm_eps)
            if fam == "moe":
                x = x + moe_mod.moe_apply(pl["moe"], cfg, h2)[0]
            else:
                x = x + lyr.mlp_apply(pl["mlp"], cfg, h2)
    elif fam == "hybrid":
        ps, start, states = params["shared"], 0, []
        for g, cnt in enumerate(zamba_groups(cfg)):
            h = lyr.rms_norm(x, ps["norm1"], cfg.norm_eps)
            a = lyr.decode_self_attention(
                ps["attn"], cfg, h, cache["shared_k"][g],
                cache["shared_v"][g], kv_pos, pos)[0]
            x = x + a
            h2 = lyr.rms_norm(x, ps["norm2"], cfg.norm_eps)
            x = x + lyr.mlp_apply(ps["mlp"], cfg, h2)
            for i in range(start, start + cnt):
                pl = _layer(params["layers"], i)
                h = lyr.rms_norm(x, pl["norm"], cfg.norm_eps)
                out, st = mb.mamba2_decode(pl, cfg, h,
                                           _layer(cache["mamba"], i))
                x = x + out
                states.append(st)
            start += cnt
        _store_states(cache["mamba"], states)
    elif fam == "ssm":
        states = []
        for i in range(L):
            x, st = rwkv.rwkv_block_decode(_layer(params["layers"], i), cfg,
                                           x, _layer(cache["rwkv"], i))
            states.append(st)
        _store_states(cache["rwkv"], states)
    else:
        raise ValueError(f"unknown family {fam!r}")
    x = lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lyr.logits_apply(params["embed"], cfg, x)[:, 0]
    return logits, cache


# --------------------------------------------------------------------------
# prefill → cache
def _head(keep: int) -> tuple:
    """The index of a (L, B, W, ...) cache's first ``keep`` slots."""
    return (slice(None), slice(None), slice(None, keep))


# --------------------------------------------------------------------------
def prefill(params, cfg, tokens, *, cond=None, max_len: int | None = None,
            impl: str = "auto"):
    """Run the full prompt and build a decode cache of size ``max_len``.

    Returns (last_token_logits (B, V), cache). The K/V caches (and the
    hybrid's shared-block cache) hold the last ``min(S, W)`` positions;
    under a sliding window shorter than the prompt they lie in the rolling
    buffer's order (position p at slot p % W), and with ``+kv8`` the
    self-attention K/V are quantized as decode quantizes them. The cross
    K/V and the recurrent states are cast to their cache dtypes; under a
    mesh every leaf of the cache keeps the policy's placements.
    """
    B, S = tokens.shape
    max_len = max_len or S
    x, _, parts = forward(params, cfg, tokens, cond=cond, mode="prefill",
                          impl=impl)
    cache = init_cache(cfg, B, max_len, x.device)
    if "kv_pos" in cache:
        W = _window(cfg, max_len)
        keep = min(S, W)
        pos_tail = torch.arange(S - keep, S, dtype=torch.int32,
                                device=x.device)
        order = None
        if cfg.sliding_window and S > W:
            # rolling buffer: slot of absolute position p is p % W
            order = torch.argsort(pos_tail % W)
            pos_tail = pos_tail[order]
        for side in ("k", "v", "shared_k", "shared_v"):
            if side not in cache:
                continue
            # (L, B, S, KV, hd) → the last `keep` positions, slot-ordered
            src = parts[side][:, :, S - keep:]
            if order is not None:
                src = src[:, :, order]
            if _kv_int8(cfg):  # only k and v: hybrids have no int8 cache
                q, scale = lyr.quantize_kv(src)
                shd.index_write(cache[side], _head(keep), q)
                shd.index_write(cache[side + "_scale"], _head(keep), scale)
            else:
                shd.index_write(cache[side], _head(keep),
                                src.to(cache[side].dtype))
        shd.index_write(cache["kv_pos"], _head(keep)[1:], pos_tail[None])
    for side in ("cross_k", "cross_v"):
        if side in cache:
            cache[side] = shd.placed_like(
                parts[side].to(cache[side].dtype), cache[side])
    for key in ("mamba", "rwkv"):
        if key in cache:
            cache[key] = tree_map(
                lambda dst, src: shd.placed_like(src.to(dst.dtype), dst),
                cache[key], parts[key])
    logits = lyr.logits_apply(params["embed"], cfg, x[:, -1:])[:, 0]
    return logits, cache
