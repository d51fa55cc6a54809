"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, top_k=2, d_ff_expert=32768, rope_theta=1e4, norm="rmsnorm")

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=8.0, norm="rmsnorm")
