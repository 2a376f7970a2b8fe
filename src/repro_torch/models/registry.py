"""Model registry: family → implementation module."""

from __future__ import annotations

from types import ModuleType

from . import transformer
from .config import ModelConfig


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "dense":
        return transformer
    raise NotImplementedError(
        f"model family {cfg.family!r} is not yet ported")
