"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384, MoE 8e top-2.

Sliding-window attention (4096) per assignment; vocab=32768.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32_768,
    mlp_type="swiglu",
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)
