"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304,
NON-PARAMETRIC LayerNorm (no scale/bias). [arXiv:2402.00838; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=50304, head_dim=128,
    norm="layernorm_np", tie_embeddings=True)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, norm="layernorm_np",
    tie_embeddings=True)
