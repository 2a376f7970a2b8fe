"""Decoder-only transformer LM: parameter declaration and init.

Layers are stacked (a leading ``n_layers`` axis on every layer parameter),
as in the JAX package.  ``forward`` and ``decode_step`` come with a later
slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .config import ModelConfig
from .modules import ParamSpec, attention_specs, ffn_specs, materialize

Params = Dict[str, Any]


def _stack_specs(layer: Params, n: int) -> Params:
    if isinstance(layer, ParamSpec):
        return ParamSpec((n,) + layer.shape, ("layers",) + layer.axes,
                         layer.scale, layer.dtype)
    return {k: _stack_specs(v, n) for k, v in layer.items()}


def specs(cfg: ModelConfig) -> Params:
    layer = {
        "attn_norm": ParamSpec((cfg.d_model,), ("embed",)),
        "attn": attention_specs(cfg),
        "ffn_norm": ParamSpec((cfg.d_model,), ("embed",)),
        "ffn": ffn_specs(cfg),
    }
    p: Params = {"layers": _stack_specs(layer, cfg.n_layers),
                 "final_norm": ParamSpec((cfg.d_model,), ("embed",)),
                 "unembed": ParamSpec((cfg.d_model, cfg.vocab),
                                      ("embed", "vocab"))}
    if cfg.frontend == "none":
        p["embed"] = ParamSpec((cfg.vocab, cfg.d_model),
                               ("vocab_in", "embed_in"))
    else:
        # audio/vlm frontends are stubs: inputs arrive as precomputed
        # frame/patch embeddings; a linear adapter stands in for the tower.
        p["adapter"] = ParamSpec((cfg.d_model, cfg.d_model),
                                 ("embed", "embed2"))
    return p


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    return materialize(specs(cfg), generator, cfg.param_dtype, device)
