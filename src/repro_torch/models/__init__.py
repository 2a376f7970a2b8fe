"""Model zoo: dense transformers and the pure-SSM model (Mamba-2)."""

from .config import ModelConfig
from .registry import get_model

__all__ = ["ModelConfig", "get_model"]
