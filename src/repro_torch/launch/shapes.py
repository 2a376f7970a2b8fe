"""Assigned input shapes × per-arch applicability.

  train_4k      seq 4,096    global_batch 256   → train_step
  prefill_32k   seq 32,768   global_batch 32    → prefill_step
  decode_32k    seq 32,768   global_batch 128   → serve_step (1 token)
  long_500k     seq 524,288  global_batch 1     → serve_step (1 token)

Skips (recorded, not silently dropped):
  * long_500k needs sub-quadratic attention → only ssm/hybrid archs;
  * encoder-only archs (hubert) have no decode step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    spec = SHAPES[shape]
    if spec.kind == "decode" and not cfg.causal:
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch skips long_500k "
                "(needs sub-quadratic attention; DESIGN.md §4)")
    return None


def cells(archs, shapes=None):
    """Yield (arch, shape) runnable cells + the skip list."""
    from ..configs import get_config
    shapes = shapes or list(SHAPES)
    runnable, skipped = [], []
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            r = skip_reason(cfg, s)
            if r is None:
                runnable.append((a, s))
            else:
                skipped.append((a, s, r))
    return runnable, skipped
