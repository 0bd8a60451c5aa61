"""Shared building blocks: the subset of ``repro.models.layers`` that the
RWKV6 serving path uses (RMS norm, embedding and head).

Attention, RoPE, the MLPs, ``softmax_xent_chunked`` and the dense
family's embedding variants (tied tables, gemma's ``sqrt(d_model)``
scale, the ``1 + w`` norm) come with the dense slice (ROADMAP A9).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import ParamDef

__all__ = ["rms_norm", "embed_defs", "embed_apply", "logits_apply"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def embed_defs(cfg) -> dict:
    return {name: ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="small") for name in ("table", "head")}


def embed_apply(p: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens].to(cfg.dtype)


def logits_apply(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,vd->bsv", x, p["head"].to(x.dtype))
