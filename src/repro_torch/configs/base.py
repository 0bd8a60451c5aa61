"""The architecture config dataclass.

A copy of ``repro.configs.base.ModelConfig`` with ``dtype`` a torch dtype,
holding only the fields the ported family (``ssm``: RWKV6) reads. The other
families' fields (attention, MoE, Mamba2, cross-attention, the KV cache) and
the shape grid come back with the families that read them (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # ssm (the other families come with ROADMAP A9)
    num_layers: int
    d_model: int
    num_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    norm_eps: float = 1e-5

    # RWKV6
    rwkv_lora_dim: int = 32
    rwkv_decay_lora_dim: int = 64

    dtype: Any = torch.bfloat16  # compute dtype (parameters are bf16)

    source: str = ""  # citation tag from the assignment table

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale config of the same family (runs on 1 CPU)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            rwkv_lora_dim=8,
            rwkv_decay_lora_dim=8,
            dtype=torch.float32,
        )
