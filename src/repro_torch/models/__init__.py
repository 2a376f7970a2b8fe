"""Model zoo: the transformer families (dense, MoE, VLM, audio), the
pure-SSM model (Mamba-2) and the Mamba-attention hybrid (Jamba)."""

from .config import ModelConfig
from .registry import get_model

__all__ = ["ModelConfig", "get_model"]
