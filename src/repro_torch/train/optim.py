"""AdamW with float32 moments over (possibly bf16) parameters, a copy of
``repro.train.optim``.

The optimizer state mirrors the ParamDef tree (:func:`opt_defs`). The
update keeps the reference's order of operations in float32: clip by the
global norm, the bias-corrected moments, ``step + wd·p``, then
``p − lr·step``, cast back to the parameter's dtype. ``torch.optim.AdamW``
is not used: it keeps its moments in the parameter's dtype, decays ``p``
before the step and places ``eps`` after a separate ``sqrt(bc2)``.

:func:`adamw_update` writes the parameters and moments in place, under
``torch.no_grad()`` (the counterpart of the reference launcher's
``donate_argnums=(0,)``: a functional update would hold a second copy of
the parameters and moments, 31 GB at ``rwkv6-3b``), and walks each leaf
in flat pieces of :data:`PIECE` elements, so its float32 temporaries stay
small beside a 734M-element stacked leaf; the arithmetic is elementwise,
so the pieces change no value.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import ParamDef, tree_defs, tree_map

__all__ = ["TrainConfig", "opt_defs", "init_opt", "adamw_update", "lr_at",
           "global_norm"]

#: elements of one piece of a leaf in the update and the norm
PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1
    # gradient compression across the slow (pod) axis: "none" | "int8_ef"
    compress: str = "none"


def _f32_like(d: ParamDef) -> ParamDef:
    return dataclasses.replace(d, dtype=torch.float32, init="zeros")


def opt_defs(param_defs) -> dict:
    """ParamDef tree for the optimizer state."""
    return {
        "m": tree_map(_f32_like, param_defs),
        "v": tree_map(_f32_like, param_defs),
        "count": ParamDef((), (), dtype=torch.int32, init="zeros"),
    }


def init_opt(params) -> dict:
    """Zero moments (float32) beside ``params``, and a 0-d int32 count on
    the parameters' device."""
    z = lambda: tree_map(lambda p: torch.zeros(  # noqa: E731
        p.shape, dtype=torch.float32, device=p.device), params)
    dev = next(t for _, t in tree_defs(params)).device
    return {"m": z(), "v": z(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_at(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (float32)."""
    step = step.float()
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return tc.lr * warm * (tc.min_lr_frac + (1 - tc.min_lr_frac) * cos)


def _pieces(t: torch.Tensor):
    """``t`` flattened in ``PIECE``-element pieces; a DTensor (a sharded
    step, ``launch.dryrun``) whole, as its shards do not flatten."""
    if hasattr(t, "to_local"):
        return (t,)
    return t.reshape(-1).split(PIECE)


def _local(t, like):
    """The local shard of a DTensor ``t`` placed as ``like``; a plain
    tensor as it is."""
    if not hasattr(t, "to_local"):
        return t
    if tuple(t.placements) != tuple(like.placements):
        t = t.redistribute(like.device_mesh, like.placements)
    return t.to_local()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, leaves in the
    reference's order."""
    sq = None
    for _, g in tree_defs(tree):
        s = sum(torch.sum(torch.square(piece.float()))
                for piece in _pieces(g))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


@torch.no_grad()
@torch.profiler.record_function("adamw")
def adamw_update(tc: TrainConfig, params, grads, opt):
    """One AdamW step, in place, in a ``record_function("adamw")`` range.
    Returns (params, opt, metrics): the same parameter and moment tensors,
    updated, and ``{"grad_norm", "lr"}``."""
    count = opt["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(tc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(tc, count)
    bc1 = 1 - tc.b1 ** count.float()
    bc2 = 1 - tc.b2 ** count.float()
    if hasattr(gnorm, "full_tensor"):  # a sharded step: on every shard
        scale, lr, bc1, bc2 = (x.full_tensor() for x in (scale, lr, bc1, bc2))
    flat = [t for _, t in tree_defs(params)]
    rest = ([t for _, t in tree_defs(tree)]
            for tree in (grads, opt["m"], opt["v"]))
    for p, g, m, v in zip(flat, *rest):
        g, m, v = (_local(t, p) for t in (g, m, v))
        p = _local(p, p)
        for pp, gp, mp, vp in zip(p.view(-1).split(PIECE), _pieces(g),
                                  m.view(-1).split(PIECE),
                                  v.view(-1).split(PIECE)):
            g32 = gp.float() * scale
            mp.copy_(tc.b1 * mp + (1 - tc.b1) * g32)
            vp.copy_(tc.b2 * vp + (1 - tc.b2) * torch.square(g32))
            step = (mp / bc1) / (torch.sqrt(vp / bc2) + tc.eps)
            step = step + tc.weight_decay * pp.float()
            pp.copy_((pp.float() - lr * step).to(pp.dtype))
    opt = {"m": opt["m"], "v": opt["v"], "count": count}
    return params, opt, {"grad_norm": gnorm, "lr": lr}
