"""musicgen-large — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens; GELU MLP; cross-attention to precomputed
text-conditioning embeddings in every layer (frontend stubbed per assignment).
[arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    cross_attn_all_layers=True,
    n_cross_tokens=64,
    rope_theta=10_000.0,
    source="arXiv:2306.05284; hf",
)
