"""Model stack: the dense decoder family (llama3.2-1b) for serving, with
the flash attention kernel in every prefill layer."""
from .model import ModelBundle, build
from .transformer import DecodeState, FwdOpts

__all__ = ["DecodeState", "FwdOpts", "ModelBundle", "build"]
