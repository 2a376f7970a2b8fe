"""Model registry: family → implementation module."""

from __future__ import annotations

from types import ModuleType

from . import hybrid, ssm, transformer
from .config import ModelConfig


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return hybrid
    return transformer  # dense | moe | audio | vlm
