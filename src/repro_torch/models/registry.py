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


def param_bytes(cfg: ModelConfig, bytes_per_param: int = 2) -> int:
    return cfg.param_count() * bytes_per_param
