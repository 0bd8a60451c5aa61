"""Architecture config registry.

``get_config(name)`` returns the full published config; ``--arch <id>`` in
the launchers resolves through here. Each arch module exports ``CONFIG``.
Only the families the port runs are registered: the dense archs
(``gemma-2b``, ``phi4-mini-3.8b``, ``minitron-8b``,
``command-r-plus-104b``) and ``rwkv6-3b`` (``ssm``). The moe, hybrid,
vlm and audio archs come with their families (ROADMAP A9).
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
    "rwkv6-3b": "rwkv6_3b",
}


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(name: str) -> ModelConfig:
    """Resolve an arch id; ``<arch>-smoke`` selects
    :meth:`ModelConfig.reduced`, and ``+`` suffixes select runtime
    variants: ``+kv8`` an int8-quantized serving KV cache, ``+ac<N>`` an
    attention KV chunk of N."""
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
