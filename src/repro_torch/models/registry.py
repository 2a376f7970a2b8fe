"""Model registry: family → implementation module."""

from __future__ import annotations

from types import ModuleType

from . import ssm, transformer
from .config import ModelConfig


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family in ("dense", "moe"):
        return transformer
    if cfg.family == "ssm":
        return ssm
    raise NotImplementedError(
        f"model family {cfg.family!r} is not yet ported")
