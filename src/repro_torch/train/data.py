"""Deterministic synthetic data pipeline.

Each (step, shard) pair maps to an independent counter-based stream, so a
restarted or re-sharded job regenerates identical batches — the property
elastic resume relies on (no data-order drift across failures).  Batches
are numpy arrays; the step functions put them on their device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, step: int, global_batch: int,
                    seq: int, vocab_cap: int = 0) -> Dict[str, np.ndarray]:
    v = min(cfg.vocab, vocab_cap) if vocab_cap else cfg.vocab
    rng = np.random.Generator(np.random.Philox(key=step))
    batch: Dict[str, np.ndarray] = {}
    if cfg.frontend == "none":
        tokens = rng.integers(0, v, size=(global_batch, seq + 1),
                              dtype=np.int32)
        batch["tokens"] = tokens[:, :-1]
        batch["targets"] = tokens[:, 1:]
    else:
        batch["frames"] = rng.normal(
            size=(global_batch, seq, cfg.d_model)).astype(np.float32)
        batch["targets"] = rng.integers(
            0, v, size=(global_batch, seq), dtype=np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (global_batch, 1))
    batch["positions"] = (np.repeat(pos[..., None], 3, axis=-1)
                          if cfg.rope == "mrope" else pos)
    return batch
