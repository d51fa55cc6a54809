"""whisper-medium [audio]: enc-dec, 24L+24L d_model=1024 16H (MHA)
d_ff=4096 vocab=51865; conv frontend STUBBED (input_specs provides 1500
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
    qkv_bias=True, norm="layernorm", act="gelu", mlp_gated=False,
    encoder_layers=24, encoder_seq=1500)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, qkv_bias=True,
    norm="layernorm", act="gelu", mlp_gated=False, encoder_layers=2,
    encoder_seq=30)
