"""Model zoo (dense transformers so far)."""

from .config import ModelConfig
from .registry import get_model

__all__ = ["ModelConfig", "get_model"]
