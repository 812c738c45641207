"""Model configurations: a copy of ``repro.configs`` (data only)."""
from .base import ARCH_IDS, SHAPES, ModelConfig, get_config

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "get_config"]
