"""phi4-mini-3.8b — 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

RoPE (partial fraction 0.75), SwiGLU, GQA, tied embeddings.
[arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    mlp_type="swiglu",
    tie_embeddings=True,
    rope_fraction=0.75,
    rope_theta=10_000.0,
    source="arXiv:2412.08905; hf",
)
