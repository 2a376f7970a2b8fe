"""Model building blocks — functional, nested-dict params.

Parameters are nested dicts of tensors with the JAX package's names and axis
order (``wq`` is ``(d_model, H, hd)``), so weights cross between the two
packages with no reshaping.  This module holds what ``init`` needs; the
attention, norm, RoPE and FFN math come with a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..device import resolve_device

Params = Dict[str, Any]


class ParamSpec:
    """Declares one parameter: shape + logical axes + init scale."""

    def __init__(self, shape, axes, scale: float = 1.0, dtype=torch.float32):
        assert len(shape) == len(axes), (shape, axes)
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        self.scale = scale
        self.dtype = dtype


def materialize(tree, generator: torch.Generator,
                param_dtype=torch.float32, device="cuda") -> Params:
    """Turn a ParamSpec tree into tensors drawn from ``generator``, which
    must live on ``device``.  Leaves are drawn in sorted key order, the order
    in which ``jax.tree.flatten`` visits a dict; the draws themselves differ
    from ``jax.random``'s."""
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, ParamSpec):
            fan_in = node.shape[0] if node.shape else 1
            std = node.scale / math.sqrt(max(1, fan_in))
            return torch.randn(node.shape, generator=generator, device=dev,
                               dtype=param_dtype).mul_(std)
        return {k: build(node[k]) for k in sorted(node)}

    return build(tree)


def attention_specs(cfg) -> Params:
    hd = cfg.head_dim
    return {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd),
                        ("embed", "heads", "head_dim")),
        "wk": ParamSpec((cfg.d_model, cfg.kv_heads, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((cfg.d_model, cfg.kv_heads, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model),
                        ("heads", "head_dim", "embed")),
    }


def ffn_specs(cfg) -> Params:
    if cfg.n_experts > 1:
        raise NotImplementedError("MoE FFN is not yet ported")
    if cfg.ffn_act == "swiglu":
        return {
            "wi": ParamSpec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "wg": ParamSpec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "wo": ParamSpec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
        "wo": ParamSpec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
    }
