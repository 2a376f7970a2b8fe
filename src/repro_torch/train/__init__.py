"""Training substrate: AdamW, the train/prefill/decode step builders and
the data pipeline."""

from .data import synthetic_batch
from .optimizer import AdamWConfig, apply_updates, init_state
from .step import (TrainConfig, build_decode_step, build_prefill_step,
                   build_train_step, init_cache_blocks)

__all__ = ["AdamWConfig", "apply_updates", "init_state", "TrainConfig",
           "build_decode_step", "build_prefill_step", "build_train_step",
           "init_cache_blocks", "synthetic_batch"]
