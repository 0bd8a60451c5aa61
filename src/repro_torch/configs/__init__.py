"""Architecture config registry.

``get_config(name)`` returns the full published config; ``--arch <id>`` in
the launchers resolves through here. Each arch module exports ``CONFIG``.
Every arch of ``repro.configs`` is registered, in its order.

One departure from ``repro`` (ROADMAP F12): ``+kv8`` is refused for the
``ssm`` and ``hybrid`` families. The ssm family has no KV cache, so the
variant would change nothing; the hybrid's shared-block cache has no
int8 scales in the reference, whose decode then casts bf16 K/V to int8 by
truncation (its decode logits part from the full forward by more than
their own size).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCHS = {
    "gemma-2b": "gemma_2b",
    "minitron-8b": "minitron_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "musicgen-large": "musicgen_large",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-3b": "rwkv6_3b",
}

# families without a scaled int8 KV cache, for which ``+kv8`` is refused
_NO_KV8 = ("ssm", "hybrid")


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(name: str) -> ModelConfig:
    """Resolve an arch id; ``<arch>-smoke`` selects
    :meth:`ModelConfig.reduced`, and ``+`` suffixes select runtime
    variants: ``+kv8`` an int8-quantized serving KV cache (refused with a
    ``ValueError`` for the ssm and hybrid families, ROADMAP F12),
    ``+ac<N>`` an attention KV chunk of N."""
    parts = name.split("+")
    name, mods = parts[0], parts[1:]
    if name.endswith("-smoke"):
        cfg = get_config(name[: -len("-smoke")]).reduced()
    else:
        if name not in _ARCHS:
            raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCHS)}")
        cfg = importlib.import_module(
            f"repro_torch.configs.{_ARCHS[name]}").CONFIG
    for m in mods:
        if m == "kv8":
            if cfg.family in _NO_KV8:
                raise ValueError(
                    f"{cfg.name}+kv8: the {cfg.family} family has no scaled "
                    "int8 KV cache (ssm keeps no KV cache; the hybrid's "
                    "shared-block cache would be truncated to int8 without "
                    "scales), so +kv8 is refused")
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8",
                                      name=cfg.name + "+kv8")
        elif m.startswith("ac"):  # attention KV-chunk override, e.g. +ac512
            cfg = dataclasses.replace(cfg, attn_chunk=int(m[2:]),
                                      name=cfg.name + "+" + m)
        else:
            raise KeyError(f"unknown variant {m!r}")
    return cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["get_config", "get_shape", "list_archs", "ModelConfig",
           "ShapeConfig", "SHAPES"]
