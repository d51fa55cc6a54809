"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20, MHA) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-4B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560, n_heads=20,
    n_kv_heads=20, d_ff=6912, vocab=151936, head_dim=128, qkv_bias=True,
    rope_theta=5e6, norm="rmsnorm")

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, vocab=256, head_dim=16, qkv_bias=True)
