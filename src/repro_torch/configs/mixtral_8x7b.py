"""mixtral-8x7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 8e top-2.

Sliding-window attention (4096); vocab=32000.  [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    mlp_type="swiglu",
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)
