"""The dense transformer (OLMo): pre-norm, RoPE, causal multi-head
attention (grouped when ``kv_heads`` < ``n_heads``), SwiGLU FFN,
non-parametric LayerNorm, untied unembedding."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models import layernorm, rope, run_layers
from . import stacked


def leaves(cfg: dict):
    d = cfg["d_model"]
    h, kv, hd, f = (cfg["n_heads"], cfg["kv_heads"], cfg["head_dim"],
                    cfg["d_ff"])
    # the final norm's gain, which a non-parametric LayerNorm never reads
    top = [("final_norm", (d,), "ones", 0.0)]
    return stacked(cfg, top, [
        ("attn_norm", (d,), "ones", 0.0),
        ("attn.wq", (d, h, hd), "normal", d ** -0.5),
        ("attn.wk", (d, kv, hd), "normal", d ** -0.5),
        ("attn.wv", (d, kv, hd), "normal", d ** -0.5),
        ("attn.wo", (h, hd, d), "normal", (h * hd) ** -0.5),
        ("ffn_norm", (d,), "ones", 0.0),
        ("ffn.wi", (d, f), "normal", d ** -0.5),
        ("ffn.wg", (d, f), "normal", d ** -0.5),
        ("ffn.wo", (f, d), "normal", f ** -0.5)])


def layer(x, lw: dict, positions, cfg: dict, prec):
    eps = cfg["norm_eps"]
    h = layernorm(x, eps)
    q = rope(prec.einsum("bsd,dhk->bshk", h, lw["attn.wq"]), positions,
             cfg["rope_theta"])
    k = rope(prec.einsum("bsd,dhk->bshk", h, lw["attn.wk"]), positions,
             cfg["rope_theta"])
    v = prec.einsum("bsd,dhk->bshk", h, lw["attn.wv"])
    groups = cfg["n_heads"] // cfg["kv_heads"]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    s = x.shape[1]
    scores = prec.einsum("bshk,bthk->bhst", q, k) / math.sqrt(q.shape[-1])
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    ctx = prec.einsum("bhst,bthk->bshk", p, v)
    x = x + prec.einsum("bshk,hkd->bsd", ctx, lw["attn.wo"])
    h = layernorm(x, eps)
    gate = F.silu(prec.einsum("bsd,df->bsf", h, lw["ffn.wg"]))
    up = prec.einsum("bsd,df->bsf", h, lw["ffn.wi"])
    return x + prec.einsum("bsf,fd->bsd", gate * up, lw["ffn.wo"])


def hidden(w: dict, tokens, cfg: dict, prec):
    return layernorm(run_layers(w, tokens, cfg, prec, layer), cfg["norm_eps"])


def matrix_params(cfg: dict) -> int:
    d, hd = cfg["d_model"], cfg["head_dim"]
    attn = d * hd * (2 * cfg["n_heads"] + 2 * cfg["kv_heads"])
    mult = 3 if cfg["ffn_act"] == "swiglu" else 2
    return cfg["n_layers"] * (attn + mult * d * cfg["d_ff"]) \
        + d * cfg["vocab"]


def mixer_flops(cfg: dict, batch: int, seq: int, train: bool) -> float:
    """Causal attention's 2·s²·d a layer and sequence forward (6·s²·d to
    train), d the heads' width."""
    width = cfg["n_heads"] * cfg["head_dim"]
    return (6 if train else 2) * seq * seq * width * batch * cfg["n_layers"]
