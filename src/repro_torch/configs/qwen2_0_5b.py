"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True,
    rope_theta=1e6, norm="rmsnorm", tie_embeddings=True)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense", n_layers=2, d_model=56,
    n_heads=7, n_kv_heads=1, d_ff=96, vocab=256, head_dim=8, qkv_bias=True,
    tie_embeddings=True)
