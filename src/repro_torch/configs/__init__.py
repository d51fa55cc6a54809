"""Model configs (exact published dims) for the ported architectures."""
from .base import (ARCH_IDS, PORTED, SHAPES, ModelConfig, RunConfig,
                   ShapeConfig, get_config, get_smoke_config)

__all__ = ["ARCH_IDS", "PORTED", "SHAPES", "ModelConfig", "RunConfig",
           "ShapeConfig", "get_config", "get_smoke_config"]
