"""Prefill and decode step builders, for one card.

Each builder returns the step function and its inputs as ``device="meta"``
tensors (shapes and dtypes, no storage), as the JAX builders return
abstract ``ShapeDtypeStruct``s.  There is no mesh and no sharding: the
builder's ``device`` is where the step puts the batch, lengths and tokens
it is given (numpy arrays or tensors); params and cache must already be
there.  ``build_train_step`` comes with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..device import resolve_device
from ..models import get_model
from ..models.config import ModelConfig
from ..models.modules import ParamSpec

META = torch.device("meta")


def _meta_params(tree, dtype):
    if isinstance(tree, ParamSpec):
        return torch.empty(tree.shape, dtype=dtype, device=META)
    return {k: _meta_params(v, dtype) for k, v in tree.items()}


def make_batch_abstract(cfg: ModelConfig, global_batch: int, seq: int
                        ) -> Dict[str, torch.Tensor]:
    b, s = global_batch, seq
    batch: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "none":
        batch["tokens"] = torch.empty((b, s), dtype=torch.int32, device=META)
    else:
        batch["frames"] = torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    pos_shape = (b, s, 3) if cfg.rope == "mrope" else (b, s)
    batch["positions"] = torch.empty(pos_shape, dtype=torch.int32,
                                     device=META)
    batch["targets"] = torch.empty((b, s), dtype=torch.int32, device=META)
    return batch


def build_prefill_step(cfg: ModelConfig, global_batch: int, seq: int,
                       device="cuda"):
    """Returns (prefill_step, (params, batch) as meta tensors);
    ``prefill_step(params, batch)`` gives the last token's logits (B, V)."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    batch_abs = make_batch_abstract(cfg, global_batch, seq)
    batch_abs.pop("targets")

    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            logits = model.forward(params, batch, cfg)
        # serving returns last-token logits only (sampler input)
        return logits[:, -1, :]

    return prefill_step, (params_abs, batch_abs)


def build_decode_step(cfg: ModelConfig, global_batch: int, max_seq: int,
                      device="cuda"):
    """One-token serve_step against a max_seq KV cache (or, for the SSM
    family, the O(1) conv and SSM state; ``max_seq`` is then not used).
    Returns (serve_step, (params, cache, lengths, tokens) as meta tensors);
    ``serve_step`` returns (logits (B, 1, V), cache), the cache updated in
    place."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    if cfg.family == "ssm":
        cache_abs = model.init_cache(cfg, global_batch, device=META)
    else:
        cache_abs = model.init_cache(cfg, global_batch, max_seq, device=META)
    lengths_abs = torch.empty((global_batch,), dtype=torch.int32,
                              device=META)
    tokens_abs = torch.empty((global_batch, 1), dtype=torch.int32,
                             device=META)

    def serve_step(params, cache, lengths, tokens):
        with torch.no_grad():
            return model.decode_step(
                params, cache, torch.as_tensor(lengths, device=dev),
                torch.as_tensor(tokens, device=dev), cfg)

    return serve_step, (params_abs, cache_abs, lengths_abs, tokens_abs)
