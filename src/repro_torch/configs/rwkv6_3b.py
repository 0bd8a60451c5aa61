"""rwkv6-3b (Finch) — 32L d_model=2560, attention-free, d_ff=8960 vocab=65536.

RWKV6 time-mix with data-dependent decay (per-channel), token-shift ddlerp,
squared-ReLU channel-mix.  [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=0,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    rwkv=True,
    source="arXiv:2404.05892; hf",
)
