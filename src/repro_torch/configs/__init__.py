"""Architecture config registry.

``get_config(name)`` returns the full published config; ``--arch <id>`` in
the launchers resolves through here. Each arch module exports ``CONFIG``.
Only the families the port runs are registered: ``rwkv6-3b`` (``ssm``).
The other architectures, and the reference's ``+…`` runtime variants
(an int8 KV cache, an attention chunk), come with their families
(ROADMAP A9).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(name: str) -> ModelConfig:
    """Resolve an arch id; ``<arch>-smoke`` selects
    :meth:`ModelConfig.reduced`."""
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCHS)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCHS[name]}").CONFIG


__all__ = ["get_config", "ModelConfig"]
