"""zamba2-1.2b — 38L d_model=2048 (Mamba2) + shared attn block, vocab=32000.

Mamba2 (SSD, ssm_state=64) backbone; one weight-shared attention+MLP block
(32H GQA kv=32, d_ff=8192) interleaved every 6 Mamba layers.
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    shared_attn_every=6,
    rope_theta=10_000.0,
    source="arXiv:2411.15242; hf",
)
