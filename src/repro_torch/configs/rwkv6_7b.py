"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free, 64 heads of 64) d_ff=14336
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv_heads=64, d_ff=14336, vocab=65536, head_dim=64, rwkv=True,
    norm="layernorm")

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, rwkv=True,
    norm="layernorm")
