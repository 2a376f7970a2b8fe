"""Mamba-2 (SSD, state-space duality) layers and the pure-SSM model
(mamba2-370m): params, forward, loss and O(1)-state decode.

A whole sequence runs the stretch between the two projections (the
causal conv, softplus(dt), the SSD scan, the D skip, the gate and the
gated norm) through ``kernels.ops.ssd_mixer`` on the packed in-projection
output: for a CUDA tensor the hand-written ``ssd_fused`` kernels around the
``ssd_scan`` kernel, for a CPU tensor their plain versions around the plain
chunked scan (``kernels.ref.ssd_chunked_ref``); where a gradient is wanted,
``ssd_fused.SSDMixer`` runs the fused backward kernels around the
``ssd_scan_bwd`` kernel (or, on the CPU, the plain versions' gradients and
``kernels.ref.ssd_chunked_bwd_ref``) and returns one gradient of the packed
output.  Decode keeps a (B, H, P, N) SSM state
and a rolling depthwise-conv window per layer and runs plain PyTorch, as the
JAX package runs plain jnp there.  Stacked layers are walked by a Python
loop; under grad, ``remat="full"`` runs each layer through non-reentrant
``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps each layer there;
every other policy runs each layer plain, as the reference does.

Under a step that splits the Mamba-2 heads over ``model`` (``a_log``,
``d_skip`` and ``dt_bias`` over ``ssm_heads``, ``out_norm`` and ``w_out``'s
rows over ``inner``), each process runs the layer on its block of heads:
the z, x and dt columns of its heads and B and C whole, the causal conv
over its x channels and B and C, K4 at its heads, the gated norm over the
whole ``d_inner`` (``runtime.psum`` of the sum of squares: the composite
``rmsnorm``, outside ``ops.ssd_mixer``, which then returns y + D x) and
``w_out``'s rows, whose partial output ``from_model`` adds up
(``_head_split``, ``_in_proj``).  Decode keeps the conv window whole on every process and
the SSM state of its heads.  Such a step hands the params over as FSDP
blocks split over ``data``: each layer gathers its own weights whole over
``data`` when it runs (``_layer``, ``parallel.ctx.gather_layer``; under
"full" again in its recompute, under "none" kept by the saved products
until the backward), so ``w_in`` is gathered over ``data`` first and then
handled over ``model`` as above.  Decode gathers each layer's weights in
its turn.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import ssd_chunked_ref
from ..kernels.ssd_fused import Widths, causal_conv_ref
from ..parallel import runtime
from ..parallel.ctx import Split, constrain, gather_layer
from ..ranges import part
from .config import ModelConfig
from .modules import (ParamSpec, _split, axes_tree, cross_entropy,
                      embed_tokens, materialize, norm, rmsnorm, stack_specs,
                      unembed, unstack_layers)

Params = Dict[str, Any]
D_CONV = 4

# The chunked SSD algorithm: one copy, the kernel's plain version.
ssd_chunked = ssd_chunked_ref


def ssd_layer_specs(cfg: ModelConfig) -> Params:
    d, di, st, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * st
    return {
        "norm": ParamSpec((d,), ("embed",)),
        "w_in": ParamSpec((d, 2 * di + 2 * st + h), ("embed", "inner_all")),
        "conv_w": ParamSpec((D_CONV, conv_dim), ("conv_k", "inner_conv")),
        "a_log": ParamSpec((h,), ("ssm_heads",)),
        "d_skip": ParamSpec((h,), ("ssm_heads",)),
        "dt_bias": ParamSpec((h,), ("ssm_heads",)),
        "out_norm": ParamSpec((di,), ("inner",)),
        "w_out": ParamSpec((di, d), ("inner", "embed")),
    }


def _split_proj(proj, nz: int, nxbc: int):
    """The packed in-projection's (z, xbc, dt) columns: z of ``nz``, xbc of
    ``nxbc`` (the conv's channels), dt the rest."""
    return proj[..., :nz], proj[..., nz:nz + nxbc], proj[..., nz + nxbc:]


# Depthwise causal conv along seq, then SiLU: xbc (B,S,C), conv_w (K,C).
_causal_conv = causal_conv_ref


def _ssm_inputs(lp: Params, dt):
    """softplus(dt + dt_bias) and a = -exp(a_log), in f32."""
    dt_soft = F.softplus(dt.float() + lp["dt_bias"].float())
    return dt_soft, -torch.exp(lp["a_log"].float())


def _head_split(cfg: ModelConfig) -> Optional[Split]:
    """Where the running step splits the Mamba-2 heads over ``model``
    (``a_log``'s split; ``d_skip`` and ``dt_bias`` have its shape and axes),
    or None: every process then runs the whole layer alike.  ``out_norm``
    and ``w_out``'s rows over ``inner`` must cover the channels of the same
    heads, [r·H/m, (r+1)·H/m) at rank r: a split of one without the other
    raises."""
    specs = ssd_layer_specs(cfg)
    hs, ns = _split(specs["a_log"]), _split(specs["out_norm"])
    if (hs is None) != (ns is None):
        raise NotImplementedError(
            f"{cfg.name}: the Mamba-2 heads ({cfg.ssm_heads}) and d_inner "
            f"({cfg.d_inner}) split differently over model: "
            f"{hs} and {ns}")
    return hs


def _columns(w, ranges):
    """The columns ``ranges`` ([start, stop) pairs, in order) of ``w``'s
    last dimension, adjacent ranges merged: ``w`` itself where they cover
    it whole."""
    merged = []
    for a, b in ranges:
        if merged and merged[-1][1] == a:
            merged[-1] = (merged[-1][0], b)
        elif b > a:
            merged.append((a, b))
    if merged == [(0, w.shape[-1])]:
        return w
    return torch.cat([w[..., a:b] for a, b in merged], dim=-1)


def _in_proj(lp: Params, xn, cfg: ModelConfig, hs: Optional[Split],
             whole_x: bool = False):
    """(proj, conv_w) of this process's heads [h0, h1): the in-projection's
    output packed as z | xbc | dt, z and dt the columns of those heads, xbc
    their x columns (every x column where ``whole_x``: decode keeps the
    whole conv window) and B and C; and ``conv_w``'s columns for xbc's
    channels, as many as xbc's.

    With the heads split, the packed ``w_in`` (z | x | B | C | dt, split
    into even blocks over ``model`` that do not fall on its components) is
    gathered whole with ``gather_blocks``: each process reads its own
    columns and adds only its part to B's and C's gradient, so the
    gradient is summed over ``model`` into each block.  A ``w_in`` or
    ``conv_w`` that every process holds whole enters through ``to_model``
    for the same reason, and so does ``xn``.  With the heads whole every
    process computes every column alike, and a split ``w_in`` is gathered
    by ``gather_model`` (its gradient is the same on every process)."""
    cdt = cfg.compute_dtype
    ws = _split(ssd_layer_specs(cfg)["w_in"])
    w_in, conv_w = lp["w_in"], lp["conv_w"]
    if hs is None:
        if ws is not None:
            w_in = runtime.gather_model(w_in, ws.dim, ws.group)
        return xn @ w_in.to(cdt), conv_w
    w_in = (runtime.to_model(w_in, hs.group) if ws is None
            else runtime.gather_blocks(w_in, ws.dim, hs.group))
    conv_w = runtime.to_model(conv_w, hs.group)
    xn = runtime.to_model(xn, hs.group)
    di, st, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    h0, h1 = hs.block(cfg.ssm_heads)
    xs = (0, di) if whole_x else (h0 * p, h1 * p)
    proj = xn @ _columns(w_in, [
        (h0 * p, h1 * p), (di + xs[0], di + xs[1]),
        (2 * di, 2 * di + 2 * st),
        (2 * di + 2 * st + h0, 2 * di + 2 * st + h1)]).to(cdt)
    return proj, _columns(conv_w, [xs, (di, di + 2 * st)])


def _out_proj(lp: Params, y, cfg: ModelConfig, hs: Optional[Split]):
    """``w_out`` on the normed y: with the heads split, this process's rows,
    the partial output added up by ``from_model``."""
    out = y @ lp["w_out"].to(cfg.compute_dtype)
    return out if hs is None else runtime.from_model(out, hs.group)


def _gated_out(lp: Params, y, z, cfg: ModelConfig,
               hs: Optional[Split] = None):
    """rmsnorm(y · silu(z)) over the whole d_inner, then ``w_out``: with
    the heads split, over this process's channels, their mean of squares
    summed over ``model`` and the partial output added up by
    ``from_model``."""
    y = y.to(cfg.compute_dtype) * F.silu(z)
    y = rmsnorm(y, lp["out_norm"],
                sum_over=None if hs is None else (hs.group, cfg.d_inner))
    return _out_proj(lp, y, cfg, hs)


def _heads(cfg: ModelConfig, hs: Optional[Split]):
    return (0, cfg.ssm_heads) if hs is None else hs.block(cfg.ssm_heads)


def ssd_layer(lp: Params, x, cfg: ModelConfig,
              initial_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """Full Mamba-2 block: in-proj → conv → SSD → gated out-proj (on this
    process's heads where the step splits them; ``initial_state`` and the
    state returned are then those heads').  The stretch between the
    projections is ``ops.ssd_mixer`` on the packed in-projection output.
    The gated norm runs inside it where this process holds the whole row
    (the heads whole, or split into one block); with the heads split over
    more processes the norm over the row stays here, a composite whose sum
    of squares is added up across them (``_gated_out``)."""
    x = constrain(x, ("act_batch", None, None))
    hs = _head_split(cfg)
    xn = norm(x, lp["norm"], cfg)
    proj, conv_w = _in_proj(lp, xn, cfg, hs)
    h0, h1 = _heads(cfg, hs)
    widths = Widths(h1 - h0, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    whole_row = hs is None or hs.size == 1
    y, state = ops.ssd_mixer(proj, conv_w, lp["dt_bias"], lp["a_log"],
                             lp["d_skip"], lp["out_norm"] if whole_row
                             else None, initial_state, widths)
    if whole_row:
        out = _out_proj(lp, y, cfg, hs)
    else:
        out = _gated_out(lp, y, proj[..., :widths.heads * widths.headdim],
                         cfg, hs)
    if return_state:
        return x + out, state
    return x + out


def ssd_decode_step(lp: Params, x1, conv_state, ssm_state, cfg: ModelConfig):
    """Single-token decode.  x1: (B,1,D); conv_state: (B,K-1,conv_dim);
    ssm_state: (B,H,P,N).  Returns (y1, new_conv_state, new_ssm_state).
    Where the step splits the heads, ``conv_state`` is still whole (every
    process updates the whole window alike) and ``ssm_state`` holds this
    process's heads."""
    cdt = cfg.compute_dtype
    hs = _head_split(cfg)
    xn = norm(x1, lp["norm"], cfg)
    proj, conv_w = _in_proj(lp, xn, cfg, hs, whole_x=True)
    h0, h1 = _heads(cfg, hs)
    z, xbc, dt = _split_proj(proj, (h1 - h0) * cfg.ssm_headdim,
                             conv_w.shape[-1])
    window = torch.cat([conv_state, xbc], dim=1)              # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window,
                                   conv_w.to(cdt)))[:, None]
    di, st, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    xh = conv_out[..., h0 * p:h1 * p].reshape(-1, h1 - h0,
                                              p).float()      # (B,H,P)
    bv = conv_out[:, 0, di:di + st].float()                   # (B,N)
    cv = conv_out[:, 0, di + st:].float()
    dt_soft, a = _ssm_inputs(lp, dt[:, 0])
    decay = torch.exp(dt_soft * a)                            # (B,H)
    new_state = ssm_state * decay[..., None, None] + \
        (dt_soft[..., None] * xh)[..., None] * bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", new_state, cv)
    y = y + lp["d_skip"].float()[None, :, None] * xh
    out = _gated_out(lp, y.reshape(x1.shape[0], 1, (h1 - h0) * p), z, cfg,
                     hs)
    return x1 + out, window[:, 1:], new_state


# --------------------------------------------------------------------------
# Pure-SSM LM (mamba2-370m)
# --------------------------------------------------------------------------

def specs(cfg: ModelConfig) -> Params:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model),
                           ("vocab_in", "embed_in")),
        "layers": stack_specs(ssd_layer_specs(cfg), cfg.n_layers),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",)),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    return materialize(specs(cfg), generator, cfg.param_dtype, device)


def logical_axes(cfg: ModelConfig) -> Params:
    return axes_tree(specs(cfg))


def forward(params: Params, batch: Dict, cfg: ModelConfig):
    """batch: tokens (B,S) on the params' device (positions, if given, are
    not read).  Returns logits (B,S,V) in the compute dtype."""
    # Rows first, then the cast: the same values as casting the table.
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    # As the reference: only "full" checkpoints; every other policy runs
    # each layer plain.
    remat = torch.is_grad_enabled() and cfg.remat == "full"
    for lp in unstack_layers(params["layers"]):
        if remat:
            x = checkpoint(_layer, lp, x, cfg, use_reentrant=False)
        else:
            x = _layer(lp, x, cfg)
    return unembed(params, x, cfg)


def _layer(lp: Params, x, cfg: ModelConfig):
    """One layer of the stack: its weights gathered over ``data`` where the
    step splits them (``gather_layer``), then ``ssd_layer``; the profiler
    sees them as ``layer`` and ``mamba`` (``ranges.part``)."""
    with part("layer") as layer:
        x = layer.input(x)
        lp = gather_layer(lp, "layers")
        with part("mamba") as p:
            x = p.output(ssd_layer(lp, p.input(x), cfg))
        return layer.output(x)


def loss_fn(params: Params, batch: Dict, cfg: ModelConfig):
    return cross_entropy(forward(params, batch, cfg), batch["targets"])


def init_cache(cfg: ModelConfig, batch: int, device="cuda"):
    """Per-layer decode state: the conv window (compute dtype) and the SSM
    state (f32), both zeros."""
    dev = resolve_device(device)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, D_CONV - 1, conv_dim),
                            dtype=cfg.compute_dtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_headdim, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
    }


def decode_step(params: Params, cache, lengths, tokens, cfg: ModelConfig):
    """One-token decode; tokens (B,1).  Returns (logits (B,1,V), cache).
    ``cache["conv"]`` and ``cache["ssm"]`` are updated in place (the JAX
    package returns new arrays).  ``lengths`` is not read: the state
    carries the position."""
    x = embed_tokens(params["embed"], tokens, cfg)           # (B,1,D)
    for i, lp in enumerate(unstack_layers(params["layers"])):
        x, conv, ssm = ssd_decode_step(gather_layer(lp, "layers"), x,
                                       cache["conv"][i], cache["ssm"][i],
                                       cfg)
        cache["conv"][i].copy_(conv)
        cache["ssm"][i].copy_(ssm)
    return unembed(params, x, cfg), cache
