"""Config dataclasses for architectures and input shapes.

A copy of ``repro.configs.base`` with ``dtype`` a torch dtype. One
``ModelConfig`` per registered architecture lives in
``repro_torch/configs/<id>.py``; the shared shape grid lives here. The
config holds every field of the reference that a ported family (dense,
moe, ssm, hybrid, vlm, audio) or the shape grid reads, each at the
reference's position with its default, so :meth:`ModelConfig.reduced`
equals the reference's field by field. ``attn_bias`` comes with the first
family that builds attention biases (no registered arch sets it), and
``scan_layers`` is left out (the port walks layers in a Python loop; no
registered arch sets it). ``remat`` is the training forward's per-layer
``torch.utils.checkpoint`` policy (``models/model.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    mlp_type: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r style joint attn+FFN residual
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    sliding_window: int = 0  # 0 = full attention

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / zamba2 hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    shared_attn_every: int = 0  # zamba2: shared attn+MLP block cadence

    # RWKV6
    rwkv: bool = False
    rwkv_lora_dim: int = 32
    rwkv_decay_lora_dim: int = 64

    # cross-attention (vlm / audio conditioning)
    cross_attn_every: int = 0  # every Nth layer has cross-attn (vlm)
    cross_attn_all_layers: bool = False  # musicgen: every layer cross-attends
    n_cross_tokens: int = 0  # stub modality frontend token count

    # numerics / runtime
    dtype: Any = torch.bfloat16  # compute dtype (parameters are bf16)
    loss_chunk: int = 512  # sequence chunking for the softmax-xent head
    attn_chunk: int = 1024  # KV-block size for blocked attention
    remat: str = "nothing"  # nothing | dots | none
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (quantized serving KV cache)

    source: str = ""  # citation tag from the assignment table

    # ---- derived helpers -------------------------------------------------
    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S) full-attn KV scoring?"""
        return self.rwkv or self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def supports_shape(self, shape: "ShapeConfig") -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale config of the same family (runs on 1 CPU)."""
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        heads = 4 if self.num_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=4 if (self.shared_attn_every or self.cross_attn_every) else 2,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv if self.num_kv_heads > 1 else min(self.num_kv_heads, 1),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_cross_tokens=8 if self.n_cross_tokens else 0,
            rwkv_lora_dim=8,
            rwkv_decay_lora_dim=8,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            attn_chunk=32,
            loss_chunk=32,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
