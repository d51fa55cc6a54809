"""Model stack: the decoder-only families (dense, MoE, the Mamba hybrid,
RWKV6, the M-RoPE VLM backbone) and whisper's encoder-decoder, for serving
and training, with the flash attention kernel in every causal attention
layer's prefill."""
from .model import ModelBundle, abstract_decode_state, batch_specs, build
from .transformer import DecodeState, FwdOpts

__all__ = ["DecodeState", "FwdOpts", "ModelBundle", "abstract_decode_state",
           "batch_specs", "build"]
