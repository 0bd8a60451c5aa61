"""llama-3.2-vision-11b — 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

Text decoder with cross-attention image layers every 5th layer; the vision
tower is a stub supplying precomputed patch embeddings via input_specs().
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    mlp_type="swiglu",
    cross_attn_every=5,
    n_cross_tokens=1600,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
