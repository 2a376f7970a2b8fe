"""Decoder-only (and encoder-only) transformer LM: params, forward, loss and
dense-cache decode.

Layers are stacked (a leading ``n_layers`` axis on every layer parameter),
as in the JAX package, and the forward pass walks them with a Python loop
(``cfg.scan_layers`` has no meaning here).  With ``cfg.remat == "full"``
and grad enabled, each layer runs under non-reentrant
``torch.utils.checkpoint``, as the JAX forward wraps it in
``jax.checkpoint``: the backward pass runs it again; under ``no_grad`` the
loop is unchanged.  Covers the dense and MoE families (the FFN is
``modules.ffn``, a MoE FFN where ``n_experts > 1``); the frame frontend
(audio, VLM) and M-RoPE come with their slices.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .config import ModelConfig
from .modules import (ParamSpec, _einsum, apply_rope, attention_specs,
                      cross_entropy, ffn, ffn_specs, gqa_attention,
                      materialize, norm, stack_specs, unembed,
                      unstack_layers)

Params = Dict[str, Any]


def specs(cfg: ModelConfig) -> Params:
    layer = {
        "attn_norm": ParamSpec((cfg.d_model,), ("embed",)),
        "attn": attention_specs(cfg),
        "ffn_norm": ParamSpec((cfg.d_model,), ("embed",)),
        "ffn": ffn_specs(cfg),
    }
    p: Params = {"layers": stack_specs(layer, cfg.n_layers),
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


def _layer(cfg: ModelConfig, x, lp: Params, positions, causal: bool):
    # Profiler ranges: a step's time by part, the remat recompute included
    # (it runs inside the backward pass, under these ranges again).
    with record_function("attention"):
        h, _ = gqa_attention(lp["attn"], norm(x, lp["attn_norm"], cfg),
                             positions, cfg, causal=causal)
    x = x + h
    with record_function("ffn"):
        h = ffn(lp["ffn"], norm(x, lp["ffn_norm"], cfg), cfg)
    return x + h


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict):
    if cfg.frontend != "none":
        raise NotImplementedError("frame/patch frontends are not yet ported")
    # Rows first, then the cast: the same values as casting the table.
    return params["embed"][batch["tokens"]].to(cfg.compute_dtype)


def forward(params: Params, batch: Dict, cfg: ModelConfig):
    """batch: tokens (B,S), positions (B,S), as tensors on the params'
    device.  Returns logits (B,S,V) in the compute dtype."""
    x = _embed_inputs(params, cfg, batch)
    positions = batch["positions"]
    remat = torch.is_grad_enabled() and cfg.remat != "none"
    if remat and cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r} is not yet ported")
    for lp in unstack_layers(params["layers"]):
        if remat:
            x = checkpoint(_layer, cfg, x, lp, positions, cfg.causal,
                           use_reentrant=False)
        else:
            x = _layer(cfg, x, lp, positions, cfg.causal)
    return unembed(params, x, cfg)


def loss_fn(params: Params, batch: Dict, cfg: ModelConfig):
    return cross_entropy(forward(params, batch, cfg), batch["targets"])


# --------------------------------------------------------------------------
# Decode with a dense KV cache (the dry-run serve_step contract).
# The paged-pool cache in repro_torch.serving implements the same math
# against gathered pages (serving/kvcache.py + kernels/paged_attention).
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    dtype = cfg.kv_cache_dtype or cfg.compute_dtype
    shape = (cfg.n_layers, 2, batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def decode_step(params: Params, cache, lengths, tokens, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token decode.  cache: (L,2,B,S,kvH,hd); lengths (B,) current
    sequence lengths; tokens (B,1).  Returns (logits, cache).  The token's
    K/V rows are written into ``cache`` in place (the JAX package returns a
    new cache), so a step costs no copy of the cache."""
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not yet ported")
    b = tokens.shape[0]
    max_seq = cache.shape[3]
    cdt = cfg.compute_dtype
    rows = torch.arange(b, device=tokens.device)
    x = params["embed"][tokens].to(cdt)                        # (B,1,D)
    positions = lengths[:, None]                               # (B,1)
    kv_pos = torch.arange(max_seq, device=tokens.device)[None, :]
    kv_pos = torch.where(kv_pos <= lengths[:, None], kv_pos, -1)  # (B,S)
    for i, lp in enumerate(unstack_layers(params["layers"])):
        xn = norm(x, lp["attn_norm"], cfg)
        # new k/v for this token: f32 weights against the compute-dtype
        # activations, promoted to f32 as JAX promotes them
        k_new = _einsum("bsd,dhk->bshk", xn, lp["attn"]["wk"]).to(cdt)
        v_new = _einsum("bsd,dhk->bshk", xn, lp["attn"]["wv"]).to(cdt)
        if cfg.rope == "rope":
            k_new = apply_rope(k_new, positions, cfg.rope_theta)
        cache[i, 0, rows, lengths] = k_new[:, 0].to(cache.dtype)
        cache[i, 1, rows, lengths] = v_new[:, 0].to(cache.dtype)
        h, _ = gqa_attention(lp["attn"], xn, positions, cfg, causal=False,
                             kv_override=(cache[i, 0], cache[i, 1]),
                             kv_positions=kv_pos)
        x = x + h
        x = x + ffn(lp["ffn"], norm(x, lp["ffn_norm"], cfg), cfg)
    return unembed(params, x, cfg), cache
