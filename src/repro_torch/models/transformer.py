"""Decoder-only (and encoder-only) transformer LM: params, forward, loss and
dense-cache decode.

Layers are stacked (a leading ``n_layers`` axis on every layer parameter),
as in the JAX package, and the forward pass walks them with a Python loop
(``cfg.scan_layers`` has no meaning here).  With grad enabled and
``cfg.remat`` "full" or "dots_with_no_batch_dims", each layer runs under
non-reentrant ``torch.utils.checkpoint``, as the JAX forward wraps it in
``jax.checkpoint``: under "full" the backward pass runs the whole layer
again; under "dots_with_no_batch_dims" it keeps what
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps, the
products with no batch dimension (``saves_dot_with_no_batch_dims``), and
runs the rest again.  Under ``no_grad`` the loop is unchanged.  Covers the
families dense, moe (the FFN is ``modules.ffn``, a MoE FFN where
``n_experts > 1``), vlm (M-RoPE over (B, S, 3) positions) and audio
(encoder-only: precomputed frame embeddings through a linear adapter,
non-causal attention, no decode).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..parallel.ctx import constrain
from .config import ModelConfig
from .modules import (ParamSpec, _einsum, apply_mrope, apply_rope,
                      attention_specs, axes_tree, cross_entropy, ffn,
                      ffn_specs, gqa_attention, materialize, norm,
                      stack_specs, unembed, unstack_layers)

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


def logical_axes(cfg: ModelConfig) -> Params:
    return axes_tree(specs(cfg))


def _layer(cfg: ModelConfig, x, lp: Params, positions, causal: bool):
    # Profiler ranges: a step's time by part, the remat recompute included
    # (it runs inside the backward pass, under these ranges again).
    x = constrain(x, ("act_batch", None, None))
    with record_function("attention"):
        h, _ = gqa_attention(lp["attn"], norm(x, lp["attn_norm"], cfg),
                             positions, cfg, causal=causal)
    x = constrain(x + h, ("act_batch", None, None))
    with record_function("ffn"):
        h = ffn(lp["ffn"], norm(x, lp["ffn_norm"], cfg), cfg)
    return constrain(x + h, ("act_batch", None, None))


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def saves_dot_with_no_batch_dims(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of "dots_with_no_batch_dims": save
    the output of a product with no batch dimension, recompute every other
    op.  ``torch.einsum`` takes a weight product ("bsd,dhk->bshk",
    "bsd,dv->bsv") to ``aten.bmm`` with a batch of 1, and ``x @ w`` to
    ``aten.mm``; the score and P·V products are ``aten.bmm`` over B·H.
    K3's launch is a ctypes call that no dispatch mode sees, so under this
    policy ``FlashAttention``'s forward runs again whole."""
    if op in _MM or (op is torch.ops.aten.bmm.default
                     and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXT = {
    "dots_with_no_batch_dims": partial(create_selective_checkpoint_contexts,
                                       saves_dot_with_no_batch_dims),
}


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict):
    cdt = cfg.compute_dtype
    if cfg.frontend != "none":
        # the tower is a stub in both packages: frames (B, S, D) arrive
        # precomputed and a linear adapter stands in for it
        return batch["frames"].to(cdt) @ params["adapter"].to(cdt)
    # Rows first, then the cast: the same values as casting the table.
    return params["embed"][batch["tokens"]].to(cdt)


def forward(params: Params, batch: Dict, cfg: ModelConfig):
    """batch: tokens (B,S) or frames (B,S,D); positions (B,S) or (B,S,3)
    for M-RoPE; as tensors on the params' device.  Returns logits (B,S,V)
    in the compute dtype."""
    x = _embed_inputs(params, cfg, batch)
    positions = batch["positions"]
    # As the reference: any other policy name runs each layer plain.
    remat = torch.is_grad_enabled() and cfg.remat in ("full",
                                                      *_REMAT_CONTEXT)
    kw = ({"context_fn": _REMAT_CONTEXT[cfg.remat]}
          if cfg.remat in _REMAT_CONTEXT else {})
    for lp in unstack_layers(params["layers"]):
        if remat:
            x = checkpoint(_layer, cfg, x, lp, positions, cfg.causal,
                           use_reentrant=False, **kw)
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
    new cache), so a step costs no copy of the cache.  Under M-RoPE the
    token's three position streams are all ``lengths``, as in the JAX
    package.  A model with a frame frontend (hubert) has no token
    embedding and no decode, in either package."""
    if cfg.frontend != "none":
        raise ValueError(f"{cfg.name} is an encoder over frame embeddings "
                         "and has no decode step")
    b = tokens.shape[0]
    max_seq = cache.shape[3]
    cdt = cfg.compute_dtype
    rows = torch.arange(b, device=tokens.device)
    x = params["embed"][tokens].to(cdt)                        # (B,1,D)
    positions = lengths[:, None]                               # (B,1)
    if cfg.rope == "mrope":
        positions = positions[..., None].repeat(1, 1, 3)       # (B,1,3)
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
        elif cfg.rope == "mrope":
            k_new = apply_mrope(k_new, positions, cfg.mrope_sections)
        cache[i, 0, rows, lengths] = k_new[:, 0].to(cache.dtype)
        cache[i, 1, rows, lengths] = v_new[:, 0].to(cache.dtype)
        h, _ = gqa_attention(lp["attn"], xn, positions, cfg, causal=False,
                             kv_override=(cache[i, 0], cache[i, 1]),
                             kv_positions=kv_pos)
        x = x + h
        x = x + ffn(lp["ffn"], norm(x, lp["ffn_norm"], cfg), cfg)
    return unembed(params, x, cfg), cache
