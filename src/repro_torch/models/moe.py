"""Top-k mixture-of-experts FFN (Mixtral-style), a copy of
``repro.models.moe``.

Capacity-based dispatch: per sequence, each token's top-k expert
assignments are packed into (E, C) slots by a cumulative-position scatter
in token-major order (an assignment past an expert's C slots goes to the
overflow slot E·C and is dropped), the experts run as one batched matmul
over their capacity slots, and the results gather back weighted by the
renormalised router probabilities. The router runs in float32.

Ties: the top-k takes the lower expert index first among equal
probabilities, as ``jax.lax.top_k`` does (a stable descending sort; the
capacity cumsum depends on that order). The expert matmuls are plain
``torch.einsum`` (cuBLAS on the card): no TPU kernel lies on this path.
Each call runs inside a ``torch.profiler.record_function("moe")`` range,
so a trace reads the MoE's device time from the model's own run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models.params import ParamDef

__all__ = ["moe_defs", "moe_apply", "router_logits", "top_k"]


def moe_defs(cfg) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((D, E), ("embed", ""), dtype=torch.float32),
        "wg": ParamDef((E, D, F_), ("", "embed", "mlp")),
        "wu": ParamDef((E, D, F_), ("", "embed", "mlp")),
        "wd": ParamDef((E, F_, D), ("", "mlp", "embed")),
    }


def router_logits(p, x):
    """(B, S, D) → (B, S, E) float32 router logits."""
    return torch.einsum("bsd,de->bse", x.float(), p["router"].float())


def top_k(probs, k: int):
    """The ``k`` largest entries of the last axis and their indices,
    largest first and the lower index first among equals (a stable
    descending sort, ``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, cfg, x):
    """x: (B, S, D) -> (out, aux_loss)."""
    with torch.profiler.record_function("moe"):
        return _moe_apply(p, cfg, x)


def _dispatch(x, slot, E: int, C: int, K: int):
    """Each (E, C) capacity slot's token row of ``x`` (B, S, D), from the
    assignments' ``slot`` (B, S·K): (B, E, C, D), a zero row where a slot
    is empty."""
    B, S, D = x.shape
    tok = (torch.arange(S * K, device=x.device) // K).expand(B, S * K)
    # S = a zero row; only the overflow slot takes several writes, and it
    # is cut off below, so every kept slot has one writer
    src = torch.full((B, E * C + 1), S, dtype=torch.long, device=x.device)
    src.scatter_(1, slot, tok)
    rows = torch.arange(B, device=x.device)[:, None]
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    return xpad[rows, src[:, :E * C]].reshape(B, E, C, D)


def _moe_apply(p, cfg, x):
    B, S, D = x.shape
    x = shd.seq_whole(x)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    # Python's round, half to even, as the reference computes C
    C = max(1, int(round(cfg.capacity_factor * S * K / E)))
    dt = x.dtype

    probs = torch.softmax(router_logits(p, x), dim=-1)
    top_p, top_e = top_k(probs, K)  # (B, S, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # ---- dispatch: pack assignments into (E, C) capacity slots ----------
    fe = top_e.reshape(B, S * K)
    fw = top_p.reshape(B, S * K).to(dt)
    onehot = F.one_hot(fe, E)  # (B, S*K, E)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    keep = pos < C  # pos: the assignment's place within its expert
    slot = torch.where(keep, fe * C + pos, E * C)  # E*C = overflow slot

    # the dispatch is local to each batch row: on the local shards under a
    # mesh (DTensor has no sharded in-place scatter), else a plain call
    xe = shd.local_call(lambda xs, ss: _dispatch(xs, ss, E, C, K), (x, slot),
                        (("batch", "", "embed"), ("batch", "")),
                        (("batch", "", "", "embed"),))
    xe = shd.constrain(xe, "batch", "", "", "embed")

    # ---- expert FFN (batched over experts) -------------------------------
    # (shd.dense: a no-op with no mesh; under one, DTensor's layouts). Where
    # the capacity rows outnumber a weight's input width, its FSDP shard
    # over 'data' is gathered and each rank keeps its rows: left to pick,
    # DTensor split the experts over 'model' and gathered every row of the
    # batch to each rank. g and u are laid out before the activation: the
    # contraction over a split embed hands on partial sums, which DTensor
    # resolved inside the silu by gathering the features over 'model' and
    # reduce-scattering them over 'data' where a batch of one leaves
    # 'data' free
    rows = B * C
    wg, wu = (shd.gathered(p[k], rows, D, "", "", "mlp").to(dt)
              for k in ("wg", "wu"))
    g, u = (shd.constrain(shd.dense(torch.einsum("becd,edf->becf", xe, w)),
                          "batch", "", "", "mlp") for w in (wg, wu))
    h = F.silu(g) * u
    h = shd.dense(shd.constrain(h, "batch", "", "", "mlp"))
    wd = shd.gathered(p["wd"], rows, cfg.d_ff, "", "mlp", "").to(dt)
    y = torch.einsum("becf,efd->becd", h, wd)

    # ---- combine: local to each batch row too (DTensor's indexed read of
    # a batch-sharded tensor gathers the whole batch) ---------------------
    out, = shd.local_call(lambda ys, ss, ws: (_combine(ys, ss, ws, K),),
                          (y, slot, fw * keep.to(dt)),
                          (("batch", "", "", "embed"), ("batch", ""),
                           ("batch", "")), (("batch", "", "embed"),))
    return shd.constrain(out, "batch", "seq", "embed"), aux


def _combine(y, slot, w, K: int):
    """Each assignment's expert output from ``y`` (B, E, C, D) at its
    ``slot`` (B, S·K; the overflow slot reads a zero row), weighted by
    ``w`` (B, S·K) and summed over the ``K`` assignments of a token:
    (B, S, D)."""
    B, E, C, D = y.shape
    yflat = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))],
                      dim=1)
    rows = torch.arange(B, device=y.device)[:, None]
    gathered = yflat[rows, slot]  # (B, S*K, D)
    gathered = gathered * w[..., None]
    return gathered.reshape(B, -1, K, D).sum(dim=2)
