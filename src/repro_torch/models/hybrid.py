"""Jamba-style hybrid (jamba-v0.1-52b): Mamba-2 and attention interleaved
7:1, a MoE FFN every other layer (arXiv:2403.19887).

Layers form super-blocks of ``attn_every`` (8) positions.  Parameters are
stacked per *position* across blocks (``blocks/pos{i}``, a leading
``layers`` axis of ``n_layers // attn_every`` on every leaf), with the JAX
package's names and axis order, so a JAX tree carries across with no
reshaping.  Position roles follow the Jamba block diagram, as the JAX
package assigns them: attention at ``attn_every // 2``, Mamba elsewhere; a
MoE FFN where ``i % moe_every == 1``, a dense FFN elsewhere.

The forward pass walks the blocks with a Python loop (the JAX package
scans them).  Under grad with ``cfg.remat == "full"`` each whole block runs
under one non-reentrant ``torch.utils.checkpoint``, as the JAX forward
wraps the block in ``jax.checkpoint``; every other policy runs plain, as
the reference does.  The attention position reaches the flash kernel (K3)
through ``gqa_attention`` where ``attn_impl == "chunked"``; each Mamba
position reaches the SSD-scan kernel (K4) through ``ssm.ssd_layer``.  The
profiler sees each position as ``layer``, with ``attention`` or ``mamba``
and ``ffn`` (the MoE's own ``moe.*`` inside) in it (``ranges.part``).

Decode keeps a KV cache for the attention position of every block and
O(1) conv and SSM state for each Mamba position, in plain PyTorch.

A step across processes hands the params over as FSDP blocks split over
``data``; each position gathers its own weights whole over ``data`` when
it runs (``_apply_position``, ``parallel.ctx.gather_layer``), not a whole
block at once: one jamba block at full width is a quarter of its params.
Under ``remat == "full"`` such a step checkpoints each position in place
of the block, so that the recompute holds one position's gathered weights
at a time through the backward, not the whole block's; the values are
the same.  Under "none" the saved products keep each position's gathered
weights alive until the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.ctx import constrain, gather_layer, gathers_params
from ..ranges import part
from .config import ModelConfig
from .modules import (ParamSpec, apply_rope, attention_specs, axes_tree,
                      cross_entropy, decode_attention, decode_kv, dense_ffn,
                      embed_tokens, ffn_specs, gqa_attention, materialize,
                      moe_ffn, norm, stack_specs, unembed, unstack_layers)
from .ssm import D_CONV, ssd_decode_step, ssd_layer, ssd_layer_specs

Params = Dict[str, Any]


def _position_roles(cfg: ModelConfig):
    """[(mixer, ffn_kind)] for each position within a super-block."""
    roles = []
    for i in range(cfg.attn_every):
        mixer = "attn" if i == cfg.attn_every // 2 else "mamba"
        ffn_kind = "moe" if (cfg.n_experts > 1
                             and i % cfg.moe_every == 1) else "dense"
        roles.append((mixer, ffn_kind))
    return roles


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_experts=1)


def specs(cfg: ModelConfig) -> Params:
    n_blocks = cfg.n_layers // cfg.attn_every
    positions = {}
    for i, (mixer, ffn_kind) in enumerate(_position_roles(cfg)):
        layer: Params = {}
        if mixer == "attn":
            layer["attn_norm"] = ParamSpec((cfg.d_model,), ("embed",))
            layer["attn"] = attention_specs(cfg)
        else:
            layer["mamba"] = ssd_layer_specs(cfg)
        layer["ffn_norm"] = ParamSpec((cfg.d_model,), ("embed",))
        layer["ffn"] = ffn_specs(cfg if ffn_kind == "moe"
                                 else _dense_cfg(cfg))
        positions[f"pos{i}"] = stack_specs(layer, n_blocks)
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model),
                           ("vocab_in", "embed_in")),
        "blocks": positions,
        "final_norm": ParamSpec((cfg.d_model,), ("embed",)),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    return materialize(specs(cfg), generator, cfg.param_dtype, device)


def logical_axes(cfg: ModelConfig) -> Params:
    return axes_tree(specs(cfg))


def _ffn(cfg: ModelConfig, ffn_kind: str, lp: Params, x):
    xn = norm(x, lp["ffn_norm"], cfg)
    if ffn_kind == "moe":
        return moe_ffn(lp["ffn"], xn, cfg)
    return dense_ffn(lp["ffn"], xn, _dense_cfg(cfg))


def _apply_position(cfg: ModelConfig, i: int, lp: Params, x, positions):
    """Position ``i`` of a block on its weights ``lp`` (gathered over
    ``data`` here where the step splits them)."""
    with part("layer") as layer:
        x = layer.input(x)
        lp = gather_layer(lp, "blocks", f"pos{i}")
        x = constrain(x, ("act_batch", None, None))
        mixer, ffn_kind = _position_roles(cfg)[i]
        if mixer == "attn":
            with part("attention") as p:
                h, _ = gqa_attention(lp["attn"],
                                     norm(p.input(x), lp["attn_norm"], cfg),
                                     positions, cfg, causal=True)
                h = p.output(h)
            x = x + h
        else:
            with part("mamba") as p:
                # its own norm, residual
                x = p.output(ssd_layer(lp["mamba"], p.input(x), cfg))
        with part("ffn") as p:
            h = p.output(_ffn(cfg, ffn_kind, lp, p.input(x)))
        return layer.output(x + h)


def _block(cfg: ModelConfig, x, bp: Params, positions,
           remat: bool = False):
    """One block; with ``remat``, each position under its own
    checkpoint."""
    for i in range(cfg.attn_every):
        if remat:
            x = checkpoint(_apply_position, cfg, i, bp[f"pos{i}"], x,
                           positions, use_reentrant=False)
        else:
            x = _apply_position(cfg, i, bp[f"pos{i}"], x, positions)
    return x


def forward(params: Params, batch: Dict, cfg: ModelConfig):
    """batch: tokens (B,S), positions (B,S), as tensors on the params'
    device.  Returns logits (B,S,V) in the compute dtype."""
    # Rows first, then the cast: the same values as casting the table.
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = batch["positions"]
    # As the reference: only "full" checkpoints (a whole block, or each
    # position where the positions gather their weights); every other
    # policy runs plain.
    remat = torch.is_grad_enabled() and cfg.remat == "full"
    per_position = remat and gathers_params()
    for bp in unstack_layers(params["blocks"]):
        if remat and not per_position:
            x = checkpoint(_block, cfg, x, bp, positions,
                           use_reentrant=False)
        else:
            x = _block(cfg, x, bp, positions, per_position)
    return unembed(params, x, cfg)


def loss_fn(params: Params, batch: Dict, cfg: ModelConfig):
    return cross_entropy(forward(params, batch, cfg), batch["targets"])


# --------------------------------------------------------------------------
# Decode: the attention positions carry a KV cache, the Mamba positions
# O(1) conv and SSM state.
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zeros: ``kv`` (n_blocks, 2, B, max_seq, kvH, hd) and ``conv``
    (n_blocks, attn_every - 1, B, 3, conv_dim) in the compute dtype (the
    JAX package does not read ``kv_cache_dtype`` here), ``ssm``
    (n_blocks, attn_every - 1, B, H, P, N) in f32."""
    dev = resolve_device(device)
    n_blocks = cfg.n_layers // cfg.attn_every
    n_mamba = cfg.attn_every - 1
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    cdt = cfg.compute_dtype
    return {
        "kv": torch.zeros((n_blocks, 2, batch, max_seq, cfg.kv_heads,
                           cfg.head_dim), dtype=cdt, device=dev),
        "conv": torch.zeros((n_blocks, n_mamba, batch, D_CONV - 1,
                             conv_dim), dtype=cdt, device=dev),
        "ssm": torch.zeros((n_blocks, n_mamba, batch, cfg.ssm_heads,
                            cfg.ssm_headdim, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
    }


def decode_step(params: Params, cache, lengths, tokens, cfg: ModelConfig):
    """One-token decode; tokens (B,1), lengths (B,) current sequence
    lengths.  Returns (logits (B,1,V), cache).  The three arrays of
    ``cache`` are updated in place (the JAX package returns new ones): the
    token's K/V rows at ``lengths`` and each Mamba position's conv window
    and SSM state."""
    x = embed_tokens(params["embed"], tokens, cfg)             # (B,1,D)
    positions = lengths[:, None]                               # (B,1)
    roles = _position_roles(cfg)
    for blk, bp in enumerate(unstack_layers(params["blocks"])):
        m = 0
        for i, role in enumerate(roles):
            attn = role[0] == "attn"
            state = (cache["kv"][blk] if attn
                     else (cache["conv"][blk][m], cache["ssm"][blk][m]))
            x = _decode_position(cfg, role,
                                 gather_layer(bp[f"pos{i}"], "blocks",
                                              f"pos{i}"),
                                 x, positions, lengths, state)
            m += not attn
    return unembed(params, x, cfg), cache


def _decode_position(cfg: ModelConfig, role, lp: Params, x, positions,
                     lengths, state):
    """One position's decode on its weights ``lp``: ``state`` is the
    block's KV cache (attention) or the position's (conv, SSM) state
    (Mamba), updated in place."""
    mixer, ffn_kind = role
    if mixer == "attn":
        xn = norm(x, lp["attn_norm"], cfg)
        k_new, v_new = decode_kv(lp["attn"], xn, cfg)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        x = x + decode_attention(lp["attn"], xn, positions, lengths,
                                 (k_new, v_new), state, cfg)
    else:
        conv, ssm = state
        x, new_conv, new_ssm = ssd_decode_step(lp["mamba"], x, conv, ssm,
                                               cfg)
        conv.copy_(new_conv)
        ssm.copy_(new_ssm)
    return x + _ffn(cfg, ffn_kind, lp, x)
