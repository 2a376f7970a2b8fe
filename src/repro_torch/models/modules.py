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
from torch.profiler import record_function

from ..device import resolve_device
from ..kernels import ops
from ..parallel.ctx import constrain

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


def axes_tree(tree):
    """Parallel tree of logical-axes tuples."""
    if isinstance(tree, ParamSpec):
        return tree.axes
    return {k: axes_tree(v) for k, v in tree.items()}


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
# Rotary embeddings (RoPE, and Qwen2-VL's M-RoPE)
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
    return _rotate_pairs(x, ang)


def _rotate_pairs(x, ang):
    """Each interleaved pair of x (..., S, H, D) rotated by its angle
    ``ang`` (..., S, D/2), the same for every head."""
    ang = ang[..., None, :]                                  # (...,S,1,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_mrope(x, positions3, sections=(16, 24, 24), theta: float = 1e6):
    """Qwen2-VL multimodal RoPE: the head_dim/2 rotary frequencies split
    into (temporal, height, width) sections, each driven by its own
    position stream.  x: (..., S, H, D); positions3: (..., S, 3) int."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device).float()           # (D/2,)
    sec_id = torch.cat([torch.full((s,), i, device=x.device)
                        for i, s in enumerate(sections)])
    pos = positions3.float()[..., sec_id]                    # (...,S,D/2)
    return _rotate_pairs(x, pos * freqs)


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
        # theta: apply_mrope's default (1e6), not cfg.rope_theta, as the
        # JAX package calls it
        return (apply_mrope(q, positions, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.mrope_sections))
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
# FFN: dense (SwiGLU / GELU) and Mixture-of-Experts
# --------------------------------------------------------------------------

def ffn_specs(cfg) -> Params:
    if cfg.n_experts > 1:
        e = cfg.n_experts
        return {
            "router": ParamSpec((cfg.d_model, e), ("embed", "expert")),
            "wi": ParamSpec((e, cfg.d_model, cfg.d_ff),
                            ("expert", "embed", "mlp")),
            "wg": ParamSpec((e, cfg.d_model, cfg.d_ff),
                            ("expert", "embed", "mlp")),
            "wo": ParamSpec((e, cfg.d_ff, cfg.d_model),
                            ("expert", "mlp", "embed")),
        }
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


def moe_route(logits, cfg) -> Params:
    """The routing plan of ``moe_ffn`` from the router's f32 logits (N, E),
    as the JAX package computes it:

    * ``idx`` (N, k): each token's k largest logits' experts, largest first
      and the lower expert first among equal logits, as ``jax.lax.top_k``
      orders them: a stable descending sort (``torch.topk`` does not
      specify the order of ties on CUDA, and bf16 products make ties);
    * ``gates`` (N, k): the f32 softmax over those k logits, cast to the
      compute dtype; the only member that carries a gradient;
    * ``order`` (N·k,): the flattened (token, choice) pairs, stably sorted
      by expert;
    * at each position of ``order``: ``tok``, the pair's token; ``keep``,
      whether its rank within its expert is below ``cap`` =
      max(⌈N·k/E·capacity_factor⌉, 8); ``slot``, its row in the (E·cap, D)
      expert buffer, or E·cap (the overflow bin) where it is dropped;
    * ``cap``.
    """
    n, e = logits.shape
    k = cfg.top_k
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1).to(cfg.compute_dtype)
    idx = idx[:, :k]
    cap = max(int(math.ceil(n * k / e * cfg.capacity_factor)), 8)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=idx.device),
                                side="left")
    rank = torch.arange(n * k, device=idx.device) - starts[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    return {"gates": gates, "idx": idx, "order": order, "slot": slot,
            "tok": order // k, "keep": keep, "cap": cap}


def _pair_terms(rows, index, mask, weights=None):
    """(N, k, D): ``rows[index]`` (times ``weights`` where given) where
    ``mask``, zero elsewhere.  One gather of N·k rows: ``index_select``
    where ``rows[index]`` would take the slower generic indexing kernel."""
    n, k = index.shape
    terms = rows.index_select(0, index.reshape(-1)).view(n, k, -1)
    if weights is not None:
        terms = terms * weights[..., None]
    return torch.where(mask[..., None], terms, 0)


def pair_sum(rows, index, mask, weights=None):
    """(N, D): for each token, the sum over j = 0..k-1 of ``rows[index[:,
    j]]`` (times ``weights[:, j]`` where given), where ``mask[:, j]``
    (elsewhere the term is zero), added left to right, each add rounded to
    the rows' dtype.  With each token's pairs in ascending expert order
    this is the order in which the JAX package's scatter-add over repeated
    tokens adds them (ascending position in ``order``).  Gathers only: no
    atomics, so every run gives the same bits."""
    terms = _pair_terms(rows, index, mask, weights)
    out = terms[:, 0]
    for j in range(1, index.shape[1]):
        out = out + terms[:, j]
    return out


def _moe_maps(plan, n_experts: int) -> Params:
    """Gather maps between a plan's two row spaces: a token's pairs, and
    the (E·cap) buffer's slots.  ``pair_slot``, ``pair_keep`` (N, k): each
    token's pairs in ascending expert order (ascending position in
    ``order``), their slots (0 where dropped) and ``keep``; ``jperm``
    (N, k): which choice of ``idx`` each is.  ``slot_tok``, ``slot_pos``
    (E·cap,): the token and position of the pair that fills each slot (0
    where none does), ``filled``."""
    order, cap = plan["order"], plan["cap"]
    n, k = plan["idx"].shape
    dev = order.device
    pos, jperm = torch.argsort(order).view(n, k).sort(dim=-1)
    keep = plan["keep"][pos]
    sorted_e = plan["idx"].reshape(-1)[order]
    experts = torch.arange(n_experts, device=dev)
    starts = torch.searchsorted(sorted_e, experts, side="left")
    counts = torch.searchsorted(sorted_e, experts, side="right") - starts
    s = torch.arange(n_experts * cap, device=dev)
    filled = s % cap < counts[s // cap]
    slot_pos = torch.where(filled, starts[s // cap] + s % cap, 0)
    return {"pair_slot": torch.where(keep, plan["slot"][pos], 0),
            "pair_keep": keep, "jperm": jperm,
            "slot_tok": plan["tok"][slot_pos], "slot_pos": slot_pos,
            "filled": filled}


class _Dispatch(torch.autograd.Function):
    """Token rows (N, D) into the expert buffer (E·cap, D): a filled slot
    takes its pair's token row, an empty one zeros.  A token feeds up to k
    slots, so its gradient adds up to k rows: ``pair_sum`` adds them in
    the reference's order, where ``index_add_`` would add them by atomics
    in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, xt, maps):
        ctx.maps = maps
        return torch.where(maps["filled"][:, None],
                           xt.index_select(0, maps["slot_tok"]), 0)

    @staticmethod
    def backward(ctx, dbuf):
        m = ctx.maps
        return pair_sum(dbuf, m["pair_slot"], m["pair_keep"]), None


class _Combine(torch.autograd.Function):
    """The expert rows (E·cap, D) back to tokens (N, D): each token's kept
    pairs' rows, each times its gate, added by ``pair_sum`` in the
    reference's order.  The backward gathers too: a filled slot's
    gradient is its token's times its gate, a gate's the sum of its row
    times its token's gradient (a batched product, f32 accumulation)."""

    @staticmethod
    def forward(ctx, out, gates, order, maps):
        g = gates.gather(1, maps["jperm"])
        # the gate of the pair that fills each slot
        slot_gate = gates.reshape(-1)[order[maps["slot_pos"]]]
        ctx.save_for_backward(out, g, slot_gate)
        ctx.maps = maps
        return pair_sum(out, maps["pair_slot"], maps["pair_keep"], g)

    @staticmethod
    def backward(ctx, dy):
        out, g, slot_gate = ctx.saved_tensors
        m = ctx.maps
        dout = dgates = None
        if ctx.needs_input_grad[0]:
            dout = torch.where(m["filled"][:, None],
                               dy.index_select(0, m["slot_tok"])
                               * slot_gate[:, None], 0)
        if ctx.needs_input_grad[1]:
            rows = _pair_terms(out, m["pair_slot"], m["pair_keep"])
            dg = torch.bmm(rows, dy[:, :, None])[..., 0]
            # back from ascending expert order to idx's order
            dgates = dg.gather(1, torch.argsort(m["jperm"], dim=-1))
        return dout, dgates, None, None


def moe_experts(p: Params, xt, plan, cfg):
    """The MoE FFN on a routing plan: xt (N, D) in the compute dtype into
    the (E, cap, D) buffer, the per-expert SwiGLU products, and the gated
    combine; returns (N, D).  ``p`` is already in the compute dtype."""
    n, d = xt.shape
    e, cap = cfg.n_experts, plan["cap"]
    maps = _moe_maps(plan, e)
    with record_function("moe.dispatch"):
        # expert-sharded buffer: under expert parallelism the dispatch is
        # the token all-to-all
        buf = constrain(_Dispatch.apply(xt, maps).view(e, cap, d),
                        ("expert", None, None))
    with record_function("moe.experts"):
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"])) * \
            torch.einsum("ecd,edf->ecf", buf, p["wi"])
        out = torch.einsum("ecf,efd->ecd", h, p["wo"])
    with record_function("moe.combine"):
        return _Combine.apply(out.reshape(e * cap, d), plan["gates"],
                              plan["order"], maps)


def moe_ffn(p: Params, x, cfg):
    """Top-k MoE with capacity-based sort dispatch, as the JAX package's
    ``moe_ffn``: tokens flattened, routed (``moe_route``), packed into an
    (E, cap, D) buffer (overflow dropped), processed with per-expert
    einsums and combined with the router's gates (``moe_experts``).  The
    profiler sees its parts as ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine``."""
    b, s, d = x.shape
    p = {k: w.to(cfg.compute_dtype) for k, w in p.items()}
    xt = x.reshape(b * s, d).to(cfg.compute_dtype)
    with record_function("moe.route"):
        plan = moe_route((xt @ p["router"]).float(), cfg)
    y = moe_experts(p, xt, plan, cfg)
    return y.reshape(b, s, d).to(x.dtype)


def ffn(p: Params, x, cfg):
    if cfg.n_experts > 1:
        return moe_ffn(p, x, cfg)
    return dense_ffn(p, x, cfg)
