"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE (t/h/w sections), dynamic-resolution vision frontend
STUBBED (input_specs provides precomputed patch embeddings + 3D position
ids). [arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=29568, vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6, mrope_sections=(16, 24, 24), input_mode="embeddings",
    norm="rmsnorm")

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, qkv_bias=True,
    mrope_sections=(2, 3, 3), input_mode="embeddings", norm="rmsnorm")
