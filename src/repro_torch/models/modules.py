"""Model building blocks — functional, nested-dict params.

Parameters are nested dicts of tensors with the JAX package's names and axis
order (``wq`` is ``(d_model, H, hd)``), so weights cross between the two
packages with no reshaping.  Attention, norm, RoPE and FFN math is plain
PyTorch, as the JAX package's is plain jnp, except where the JAX package
marks the flash-attention kernel's place (``attn_impl == "chunked"``): there
``kernels.ops.attention`` runs, the hand-written kernel for a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import ops

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


def stack_specs(layer: Params, n: int) -> Params:
    """A layer's spec tree with a leading ``n_layers`` axis on every leaf."""
    if isinstance(layer, ParamSpec):
        return ParamSpec((n,) + layer.shape, ("layers",) + layer.axes,
                         layer.scale, layer.dtype)
    return {k: stack_specs(v, n) for k, v in layer.items()}


def unstack_layers(layers: Params) -> list:
    """Every layer of a stacked param tree, as views (no copy) from one
    ``unbind`` a leaf.  Under autograd each leaf's layer gradients are then
    stacked once; indexing layer by layer would build a zero-padded
    gradient of the whole stack for every layer and add them all up."""
    if not isinstance(layers, dict):
        return list(layers.unbind(0))
    parts = {k: unstack_layers(v) for k, v in layers.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


def unembed(params: Params, x, cfg):
    """Final norm, then the (d_model, vocab) product: logits (B, S, V)."""
    x = norm(x, params["final_norm"], cfg)
    return torch.einsum("bsd,dv->bsv", x,
                        params["unembed"].to(cfg.compute_dtype))


def cross_entropy(logits, targets):
    """Mean next-token loss in f32 over targets >= 0."""
    logits = logits.float()
    targets = targets.long()
    logz = torch.logsumexp(logits, dim=-1)
    # masked targets (< 0) pick any column: their term is multiplied by 0
    gold = logits.gather(-1, targets.clamp(min=0)[..., None]).squeeze(-1)
    mask = (targets >= 0).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

def rmsnorm(x, gamma=None, eps: float = 1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma
    return y.to(x.dtype)


def layernorm_nonparametric(x, eps: float = 1e-5):
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(x, gamma, cfg):
    if cfg.ln_kind == "nonparametric":
        return layernorm_nonparametric(x)
    return rmsnorm(x, gamma)


# --------------------------------------------------------------------------
# Rotary embeddings (RoPE; M-RoPE comes with the VLM slice)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """1 / theta^(2i/D) in float64, as the JAX package's numpy table, but
    made on ``device``: a copy from pageable host memory would make the
    stream drain before every RoPE."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S) int.  Rotates interleaved
    pairs (x[..., 0::2], x[..., 1::2]), as the JAX package does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device).float()
    ang = positions[..., None].float() * freqs               # (...,S,D/2)
    ang = ang[..., None, :]                                  # (...,S,1,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _einsum(eq: str, a, b):
    """``torch.einsum`` after JAX's type promotion (bf16 with f32 is f32);
    torch's own raises on mixed float types."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


# --------------------------------------------------------------------------
# Attention (GQA)
# --------------------------------------------------------------------------

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


def _rope_qk(q, k, positions, cfg):
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not yet ported")
    if cfg.rope == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    return q, k


def gqa_attention(p: Params, x, positions, cfg, causal: bool = True,
                  kv_override: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  kv_positions: Optional[torch.Tensor] = None):
    """x: (B, S, D).  Returns (out, (k, v)) — k/v pre-RoPE'd cache lines.

    With ``kv_override`` (decode), x provides queries only and attention
    runs against the supplied cache (B, S_kv, kvH, hd), masked where
    ``kv_positions`` < 0.  With ``cfg.attn_impl == "chunked"`` a causal
    self-attention goes through ``kernels.ops.attention`` (the flash
    kernel on the card; ``attn_chunk`` is not used: the kernel picks its
    own tiles); otherwise the (S, S_kv) scores are materialised.
    """
    b, s, _ = x.shape
    cdt = cfg.compute_dtype
    p = {k: w.to(cdt) for k, w in p.items()}
    q = _einsum("bsd,dhk->bshk", x, p["wq"]).to(cdt)
    if kv_override is None:
        k = _einsum("bsd,dhk->bshk", x, p["wk"]).to(cdt)
        v = _einsum("bsd,dhk->bshk", x, p["wv"]).to(cdt)
        q, k = _rope_qk(q, k, positions, cfg)
        kv_pos = positions
    else:
        k, v = kv_override
        k = k.to(cdt)
        v = v.to(cdt)
        q, _ = _rope_qk(q, q, positions, cfg)   # rope on q only
        kv_pos = kv_positions
    if cfg.attn_impl == "chunked" and kv_override is None and causal:
        ctx = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    else:
        groups = cfg.n_heads // cfg.kv_heads
        qg = q.reshape(b, s, cfg.kv_heads, groups, cfg.head_dim)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k) \
            / math.sqrt(cfg.head_dim)
        if causal and kv_override is None:
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, -1e30)
        elif kv_override is not None and kv_pos is not None:
            # decode: mask cache slots beyond each sequence's length
            valid = kv_pos[:, None, None, None, :] >= 0
            scores = scores.masked_fill(~valid, -1e30)
        w = torch.softmax(scores.float(), dim=-1).to(cdt)
        ctx = torch.einsum("bkgst,btkd->bskgd", w, v)
    ctx = ctx.reshape(b, s, cfg.n_heads, cfg.head_dim)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    return out, (k, v)


# --------------------------------------------------------------------------
# FFN: dense (SwiGLU / GELU); Mixture-of-Experts comes with its slice
# --------------------------------------------------------------------------

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


def dense_ffn(p: Params, x, cfg):
    p = {k: w.to(cfg.compute_dtype) for k, w in p.items()}
    if cfg.ffn_act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu's default
    return h @ p["wo"]


def ffn(p: Params, x, cfg):
    if cfg.n_experts > 1:
        raise NotImplementedError("MoE FFN is not yet ported")
    return dense_ffn(p, x, cfg)
