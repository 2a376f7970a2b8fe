"""Model building blocks — functional, nested-dict params.

Parameters are nested dicts of tensors with the JAX package's names and axis
order (``wq`` is ``(d_model, H, hd)``), so weights cross between the two
packages with no reshaping.  Attention, norm, RoPE and FFN math is plain
PyTorch, as the JAX package's is plain jnp, except where the JAX package
marks the flash-attention kernel's place (``attn_impl == "chunked"``): there
``kernels.ops.attention`` runs, the hand-written kernel for a CUDA tensor.

Under a step that runs across processes with a ``model`` axis
(``parallel.ctx.model_split``), each layer computes on its blocks of the
leaves that the step splits over ``model``: attention on its heads, the
dense FFN on its columns, the MoE on its experts, the unembedding and the
loss on its vocabulary columns, the embedding on its rows.  A replicated
activation enters such a computation through ``runtime.to_model`` and its
partial output leaves through ``runtime.from_model``.  A leaf that
``spec_for`` leaves whole (a dimension that does not divide) is computed
whole, on every process alike.  In a decode step across processes
(``parallel.ctx.seq_split``) the KV cache holds a block of the sequence
and one token's attention merges the blocks' partial softmaxes
(``decode_attention``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import ops
from ..parallel import runtime
from ..parallel.ctx import (SeqSplit, Split, batch_group, constrain,
                            gather_params, model_split, seq_split)
from ..ranges import part

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


def _split(spec: ParamSpec) -> Optional[Split]:
    """Where the running step splits the leaf ``spec`` declares over the
    ``model`` axis, or None (``parallel.ctx.model_split``)."""
    return model_split(spec.shape, spec.axes)


def vocab_split(cfg) -> Optional[Split]:
    """The split of the unembedding's vocabulary columns over ``model``,
    or None: the logits are then this process's columns."""
    return model_split((cfg.d_model, cfg.vocab), ("embed", "vocab"))


def embed_tokens(table, tokens, cfg):
    """The rows of ``tokens`` in the (vocab, d_model) table, in the compute
    dtype.  Where the step splits the table's rows over ``model``, each
    process looks the tokens up in its rows (zero for the others) and
    ``from_model`` adds: one term of each sum is not zero, so the sum is
    exact.  A negative token counts from the end, as indexing counts it.
    Where the step splits the table's columns over ``data`` (FSDP), they
    are gathered for this use (``gather_params``).  The profiler sees it
    as ``embed``."""
    with part("embed") as p:
        return p.output(_embed_rows(gather_params(p.input(table), "embed"),
                                    tokens, cfg))


def _embed_rows(table, tokens, cfg):
    sp = model_split((cfg.vocab, cfg.d_model), ("vocab_in", "embed_in"))
    if sp is None:
        # rows first, then the cast: the same values as casting the table
        return table[tokens].to(cfg.compute_dtype)
    v0, v1 = sp.block(cfg.vocab)
    local = torch.where(tokens < 0, tokens + cfg.vocab, tokens) - v0
    inside = (local >= 0) & (local < v1 - v0)
    rows = table[local.clamp(0, v1 - v0 - 1)].to(cfg.compute_dtype)
    return runtime.from_model(torch.where(inside[..., None], rows, 0),
                              sp.group)


def unembed(params: Params, x, cfg):
    """Final norm, then the (d_model, vocab) product: logits (B, S, V), or
    this process's vocabulary columns of them (``vocab_split``).  The
    norm's gain and the table are gathered over ``data`` for this use
    where the step splits them (``gather_params``).  The profiler sees it
    as ``unembed``."""
    with part("unembed") as p:
        x = norm(p.input(x), gather_params(params["final_norm"],
                                           "final_norm"), cfg)
        sp = vocab_split(cfg)
        if sp is not None:
            x = runtime.to_model(x, sp.group)
        table = gather_params(params["unembed"], "unembed")
        return p.output(torch.einsum("bsd,dv->bsv", x,
                                     table.to(cfg.compute_dtype)))


def _all_reduce(x, op, group):
    if group is not None:
        dist.all_reduce(x, op=op, group=group)


class _CrossEntropy(torch.autograd.Function):
    """The next-token loss's (sum, count) over logits that are the columns
    [v0, v0 + V_local) of the vocabulary, in f32: log Σ exp by the max
    (all-reduced MAX over ``group``) and the Σ exp below it (all-reduced
    SUM); the gold logit from the process whose columns hold the target
    (all-reduced SUM: one term is not zero).  Backward, each process's
    gradient is softmax − one-hot on its own columns.  Without a group the
    collectives are skipped: one process, every column, the same
    operations."""

    @staticmethod
    def forward(ctx, logits, targets, group, v0):
        x = logits.float()
        mask = targets >= 0
        local = targets.long() - v0
        inside = mask & (local >= 0) & (local < x.shape[-1])
        local = torch.where(inside, local, 0)
        m = x.amax(dim=-1)
        _all_reduce(m, dist.ReduceOp.MAX, group)
        se = torch.exp(x - m[..., None]).sum(dim=-1)
        _all_reduce(se, dist.ReduceOp.SUM, group)
        logz = m + torch.log(se)
        gold = torch.where(inside, x.gather(-1, local[..., None])[..., 0], 0)
        _all_reduce(gold, dist.ReduceOp.SUM, group)
        maskf = mask.float()
        count = maskf.sum()
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(logits, logz, local, inside, maskf)
        return ((logz - gold) * maskf).sum(), count

    @staticmethod
    def backward(ctx, dtotal, dcount):
        logits, logz, local, inside, maskf = ctx.saved_tensors
        p = torch.exp(logits.float() - logz[..., None])
        p = p.scatter_add(-1, local[..., None], -inside.float()[..., None])
        return (p * (maskf * dtotal)[..., None]).to(logits.dtype), None, \
            None, None


def cross_entropy_terms(logits, targets, split: Optional[Split] = None):
    """(the sum of the next-token losses over targets >= 0, their count),
    both f32 scalars: a masked mean over a batch split across processes
    divides the sum of the sums by the sum of the counts.  With ``split``
    (``vocab_split``) the logits are this process's vocabulary columns and
    the loss is vocabulary-parallel over the model group."""
    if split is None:
        return _CrossEntropy.apply(logits, targets, None, 0)
    runtime.counts["vocab_loss"] += 1
    return _CrossEntropy.apply(logits, targets, split.group,
                               split.rank * logits.shape[-1])


def cross_entropy(logits, targets):
    """Mean next-token loss in f32 over targets >= 0; the profiler sees it
    as ``loss``."""
    with part("loss") as p:
        total, count = cross_entropy_terms(p.input(logits), targets)
        return p.output(total / count.clamp(min=1.0))


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

def rmsnorm(x, gamma=None, eps: float = 1e-6, sum_over=None):
    """RMS norm over the last dimension.  With ``sum_over`` = (group,
    width), ``x`` is this process's part of a last dimension of ``width``
    split over the group: the mean of squares is taken over the whole
    (``runtime.psum`` of each part's mean, weighted by its share)."""
    x32 = x.float()
    ms = (x32 * x32).mean(-1, keepdim=True)
    if sum_over is not None:
        group, width = sum_over
        ms = runtime.psum(ms * (x.shape[-1] / width), group)
    y = x32 * torch.rsqrt(ms + eps)
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


def _kv_for_heads(t, h0: int, h1: int, groups: int):
    """The kv heads (dimension 2 of the whole ``t``) that q heads [h0, h1)
    read, head h reading kv head h // ``groups``, as a GQA layout for those
    q heads: a run of kv heads where [h0, h1) covers whole groups or lies
    in one, else one kv head for each q head."""
    first, last = h0 // groups, (h1 - 1) // groups
    if first == last or (h0 % groups == 0 and h1 % groups == 0):
        return t[:, :, first:last + 1]
    return t.index_select(2, torch.arange(h0, h1, device=t.device) // groups)


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

    Where the step splits the heads over ``model``, this process computes
    its q heads and, with ``wo``'s rows on the same heads, a partial
    output that ``from_model`` adds up.  Its kv heads are its block where
    the kv heads split too; where they do not, k and v are computed whole
    and it takes the kv heads its q heads read (``_kv_for_heads``).
    """
    b, s, _ = x.shape
    cdt = cfg.compute_dtype
    p = {k: w.to(cdt) for k, w in p.items()}
    specs = attention_specs(cfg)
    hs = _split(specs["wq"]) if kv_override is None else None
    xq = x if hs is None else runtime.to_model(x, hs.group)
    q = _einsum("bsd,dhk->bshk", xq, p["wq"]).to(cdt)
    if kv_override is None:
        if hs is None or _split(specs["wk"]) is not None:
            k = _einsum("bsd,dhk->bshk", xq, p["wk"]).to(cdt)
            v = _einsum("bsd,dhk->bshk", xq, p["wv"]).to(cdt)
        else:
            h0, h1 = hs.block(cfg.n_heads)
            g = cfg.n_heads // cfg.kv_heads
            k, v = (_kv_for_heads(runtime.to_model(
                _einsum("bsd,dhk->bshk", x, p[w]).to(cdt), hs.group),
                h0, h1, g) for w in ("wk", "wv"))
        q, k = _rope_qk(q, k, positions, cfg)
        kv_pos = positions
    else:
        k, v = kv_override
        k = k.to(cdt)
        v = v.to(cdt)
        q, _ = _rope_qk(q, q, positions, cfg)   # rope on q only
        kv_pos = kv_positions
    hq, hkv = q.shape[2], k.shape[2]
    if cfg.attn_impl == "chunked" and kv_override is None and causal:
        ctx = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    else:
        groups = hq // hkv
        qg = q.reshape(b, s, hkv, groups, cfg.head_dim)
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
    ctx = ctx.reshape(b, s, hq, cfg.head_dim)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    if hs is not None:
        out = runtime.from_model(out, hs.group)
    return out, (k, v)


def decode_kv(p: Params, xn, cfg):
    """The new token's k and v (B, 1, kvH, hd), every kv head, in the
    compute dtype and before RoPE: the f32 weights against the
    compute-dtype activations, promoted to f32 as JAX promotes them.
    Where the step splits the kv heads over ``model``, each process
    computes its block and the blocks are gathered (activations of B×kvH×hd,
    not the weights)."""
    cdt = cfg.compute_dtype
    ks = _split(attention_specs(cfg)["wk"])
    if ks is not None:
        xn = runtime.to_model(xn, ks.group)
    out = []
    for w in ("wk", "wv"):
        t = _einsum("bsd,dhk->bshk", xn, p[w]).to(cdt)
        out.append(t if ks is None else runtime.gather_model(t, 2, ks.group))
    return tuple(out)


def decode_attention(p: Params, xn, positions, lengths, kv_new, kv, cfg):
    """One token's attention against one layer's dense cache ``kv`` (2, B,
    S, kvH, hd), updated in place: the token's k and v (``kv_new``, k
    RoPE'd, (B, 1, kvH, hd) each) are written at position ``lengths[b]``
    of each row, and the query attends to positions ≤ ``lengths[b]``.
    Returns the attention's output (B, 1, D).

    In a decode step across processes (``seq_split``) see
    ``_merged_decode_attention``; otherwise the cache is whole and this
    is ``gqa_attention`` over it."""
    sq = seq_split()
    if sq is not None:
        return _merged_decode_attention(p, xn, positions, lengths, kv_new,
                                        kv, cfg, sq)
    rows = torch.arange(xn.shape[0], device=xn.device)
    kv[0, rows, lengths] = kv_new[0][:, 0].to(kv.dtype)
    kv[1, rows, lengths] = kv_new[1][:, 0].to(kv.dtype)
    kv_pos = torch.arange(kv.shape[2], device=xn.device)[None, :]
    kv_pos = torch.where(kv_pos <= lengths[:, None], kv_pos, -1)   # (B,S)
    h, _ = gqa_attention(p, xn, positions, cfg, causal=False,
                         kv_override=(kv[0], kv[1]), kv_positions=kv_pos)
    return h


def _merged_decode_attention(p: Params, xn, positions, lengths, kv_new, kv,
                             cfg, sq: SeqSplit):
    """``decode_attention`` on a cache block: positions [s0, s0 + S_loc)
    of this process's rows, every kv head, or this process's block of kv
    heads where the step splits them over ``model`` in place of the
    sequence.

    Every process computes the queries of every q head (its block of
    ``wq``'s heads, gathered over ``model``), writes the token's row
    where its block holds position ``lengths[b]``, and computes over its
    positions, in f32, each head's running max m, its sum of exponentials
    l = Σ exp(s − m) and its weighted sum of V, a = Σ exp(s − m)·v.  The
    blocks merge over ``sq.group`` by log-sum-exp: M = max m (an
    all-reduce MAX), then Σ l·exp(m − M) and Σ a·exp(m − M) (one all-reduce
    SUM), and the context is a / l.  A block whose positions all lie past
    ``lengths[b]`` has m = −1e30 and l its slot count, and drops out only
    through exp(m − M) = 0 against the block that holds position 0: so no
    block is normalised before the merge.  The context of this process's
    heads then goes through ``wo``'s rows and ``from_model``, as in
    ``gqa_attention``.  The one-device path rounds the softmax weights to
    the compute dtype before the P·V product; here the partial sums stay
    in f32."""
    b = xn.shape[0]
    cdt, hd = cfg.compute_dtype, cfg.head_dim
    g = cfg.n_heads // cfg.kv_heads
    pc = {k: w.to(cdt) for k, w in p.items()}
    hs = _split(attention_specs(cfg)["wq"])
    xq = xn if hs is None else runtime.to_model(xn, hs.group)
    q = _einsum("bsd,dhk->bshk", xq, pc["wq"]).to(cdt)
    q, _ = _rope_qk(q, q, positions, cfg)          # rope on q only
    if hs is not None:
        q = runtime.gather_model(q, 2, hs.group)
    kvh, s_loc = kv.shape[3], kv.shape[2]
    k0 = 0 if kvh == cfg.kv_heads else hs.rank * kvh
    q = q[:, :, k0 * g:(k0 + kvh) * g]
    rows = torch.arange(b, device=xn.device)
    s0 = sq.index * s_loc
    at = lengths - s0
    inside = ((at >= 0) & (at < s_loc))[:, None, None]
    at = at.clamp(0, s_loc - 1)
    for j, new in enumerate(kv_new):
        kv[j, rows, at] = torch.where(
            inside, new[:, 0, k0:k0 + kvh].to(kv.dtype), kv[j, rows, at])
    pos = s0 + torch.arange(s_loc, device=xn.device)
    valid = pos[None, :] <= lengths[:, None]                    # (B,S_loc)
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kv[0].to(cdt)) \
        / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    s32 = scores.float()
    m = s32.amax(dim=-1)                                        # (B,k,g,1)
    e = torch.exp(s32 - m[..., None])
    acc = torch.einsum("bkgst,btkd->bkgsd", e, kv[1].float())
    both = torch.cat([acc, e.sum(dim=-1)[..., None]], dim=-1)
    if sq.group is not None:
        runtime.counts["seq_merge"] += 1
        top = m.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=sq.group)
        both = both * torch.exp(m - top)[..., None]
        dist.all_reduce(both, op=dist.ReduceOp.SUM, group=sq.group)
    ctx = (both[..., :-1] / both[..., -1:]).to(cdt)             # (B,k,g,1,d)
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, 1, kvh * g, hd)
    if hs is not None:
        h0, h1 = hs.block(cfg.n_heads)
        ctx = ctx[:, :, h0 - k0 * g:h1 - k0 * g]
    out = torch.einsum("bshk,hkd->bsd", ctx, pc["wo"])
    return out if hs is None else runtime.from_model(out, hs.group)


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
    """The SwiGLU or GELU FFN; where the step splits its ``mlp`` columns
    over ``model``, on this process's columns of ``wi`` and ``wg`` and rows
    of ``wo``, the partial output added up by ``from_model``."""
    p = {k: w.to(cfg.compute_dtype) for k, w in p.items()}
    sp = _split(ffn_specs(cfg)["wi"])
    if sp is not None:
        x = runtime.to_model(x, sp.group)
    if cfg.ffn_act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu's default
    y = h @ p["wo"]
    return y if sp is None else runtime.from_model(y, sp.group)


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


def _local_maps(maps: Params, s0: int, s1: int) -> Params:
    """``_moe_maps`` cut to the buffer's slots [s0, s1) (one process's
    experts): a pair in another slot is not kept, a kept pair's slot
    counts from s0."""
    keep = maps["pair_keep"] & (maps["pair_slot"] >= s0) \
        & (maps["pair_slot"] < s1)
    return {"pair_slot": torch.where(keep, maps["pair_slot"] - s0, 0),
            "pair_keep": keep, "jperm": maps["jperm"],
            **{k: maps[k][s0:s1] for k in ("slot_tok", "slot_pos",
                                            "filled")}}


def moe_experts(p: Params, xt, plan, cfg, split: Optional[Split] = None):
    """The MoE FFN on a routing plan: xt (N, D) in the compute dtype into
    the (E, cap, D) buffer, the per-expert SwiGLU products, and the gated
    combine; returns (N, D).  ``p`` is already in the compute dtype.

    With ``split`` (the experts' weights split over ``model``), the plan
    is every process's, and this process runs its part: over the expert
    dimension (``split.dim`` 0), only its experts, rows [e0·cap, e1·cap)
    of the buffer, and combines only their pairs; over the ``mlp``
    columns, every expert on its columns.  The tokens and the gates enter
    through ``to_model`` and the partial output leaves through
    ``from_model``."""
    n, d = xt.shape
    e, cap = cfg.n_experts, plan["cap"]
    maps = _moe_maps(plan, e)
    gates = plan["gates"]
    if split is not None:
        xt = runtime.to_model(xt, split.group)
        gates = runtime.to_model(gates, split.group)
        if split.dim == 0:
            e0, e1 = split.block(e)
            maps = _local_maps(maps, e0 * cap, e1 * cap)
            e = e1 - e0
    with part("moe.dispatch") as r:
        # expert-sharded buffer: under expert parallelism the dispatch is
        # the token all-to-all
        buf = r.output(constrain(
            _Dispatch.apply(r.input(xt), maps).view(e, cap, d),
            ("expert", None, None)))
    with part("moe.experts") as r:
        x = r.input(buf)
        h = F.silu(torch.einsum("ecd,edf->ecf", x, p["wg"])) * \
            torch.einsum("ecd,edf->ecf", x, p["wi"])
        out = r.output(torch.einsum("ecf,efd->ecd", h, p["wo"]))
    with part("moe.combine") as r:
        y = r.output(_Combine.apply(r.input(out).reshape(e * cap, d), gates,
                                    plan["order"], maps))
    return y if split is None else runtime.from_model(y, split.group)


def moe_ffn(p: Params, x, cfg):
    """Top-k MoE with capacity-based sort dispatch, as the JAX package's
    ``moe_ffn``: tokens flattened, routed (``moe_route``), packed into an
    (E, cap, D) buffer (overflow dropped), processed with per-expert
    einsums and combined with the router's gates (``moe_experts``).  The
    profiler sees its parts as ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine``.

    Routing is over the whole batch: the capacity counts every token, and
    a pair's rank within its expert counts the pairs of every row before
    it, as under the JAX package's batch sharding.  So where the running
    step has split its batch over processes (``parallel.ctx.batch_group``),
    the tokens of every process are gathered first (differentiably, in rank
    order, which is the batch's row order), all of them are routed and run
    through the experts, and this process keeps its own rows.  Every
    process then does the whole batch's expert work: correct, not fast
    (ROADMAP: an expert-parallel all-to-all).

    Where the step splits the experts over ``model`` (expert
    parallelism), the router is gathered whole over the model group
    (``gather_model``), every model process routes every token alike, and
    each runs its experts (``moe_experts``)."""
    b, s, d = x.shape
    specs = ffn_specs(cfg)
    p = {k: w.to(cfg.compute_dtype) for k, w in p.items()}
    xt = x.reshape(b * s, d).to(cfg.compute_dtype)
    group = batch_group()
    if group is not None:
        xt = runtime.gather_rows(xt, group)
    router = p["router"]
    rs = _split(specs["router"])
    if rs is not None:
        router = runtime.gather_model(router, rs.dim, rs.group)
    with part("moe.route") as r:
        plan = moe_route((r.input(xt) @ router).float(), cfg)
        plan["gates"] = r.output(plan["gates"])
    y = moe_experts(p, xt, plan, cfg, _split(specs["wi"]))
    if group is not None:
        y = y[dist.get_rank(group) * b * s:][:b * s]
    return y.reshape(b, s, d).to(x.dtype)


def ffn(p: Params, x, cfg):
    if cfg.n_experts > 1:
        return moe_ffn(p, x, cfg)
    return dense_ffn(p, x, cfg)
