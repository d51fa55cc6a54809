"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert)
vocab=163840, MoE 384 experts top-8. Trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]. Adafactor recommended (see launch/train.py):
AdamW fp32 m+v for 1.03e12 params does not fit 256 chips."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840, head_dim=112,
    n_experts=384, top_k=8, d_ff_expert=2048, capacity_factor=1.25,
    rope_theta=5e4, norm="rmsnorm")

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=256, head_dim=16,
    n_experts=8, top_k=4, d_ff_expert=64, capacity_factor=8.0, norm="rmsnorm")
