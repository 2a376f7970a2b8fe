"""Mamba-2 (SSD, state-space duality) layers and the pure-SSM model
(mamba2-370m): params, forward, loss and O(1)-state decode.

The SSD scan of a whole sequence goes through ``kernels.ops.ssd``: the
hand-written ``ssd_scan`` kernel for a CUDA tensor, its plain chunked
version (``kernels.ref.ssd_chunked_ref``) for a CPU tensor; where a gradient
is wanted, its backward is the ``ssd_scan_bwd`` kernel (or, on the CPU,
``kernels.ref.ssd_chunked_bwd_ref``).  Decode keeps a (B, H, P, N) SSM state
and a rolling depthwise-conv window per layer and runs plain PyTorch, as the
JAX package runs plain jnp there.  Stacked layers are walked by a Python
loop; under grad, ``remat="full"`` runs each layer through non-reentrant
``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps each layer there;
every other policy runs each layer plain, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import ssd_chunked_ref
from .config import ModelConfig
from .modules import (ParamSpec, cross_entropy, materialize, norm, rmsnorm,
                      stack_specs, unembed, unstack_layers)

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


def _split_proj(cfg: ModelConfig, proj):
    di, st = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * st]
    dt = proj[..., di + di + 2 * st:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv along seq: xbc (B,S,C), conv_w (K,C)."""
    k = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i][None, None, :]
              for i in range(k))
    return F.silu(out)


def _ssm_inputs(lp: Params, dt):
    """softplus(dt + dt_bias) and a = -exp(a_log), in f32."""
    dt_soft = F.softplus(dt.float() + lp["dt_bias"].float())
    return dt_soft, -torch.exp(lp["a_log"].float())


def _gated_out(lp: Params, y, z, cfg: ModelConfig):
    y = rmsnorm(y.to(cfg.compute_dtype) * F.silu(z), lp["out_norm"])
    return y @ lp["w_out"].to(cfg.compute_dtype)


def ssd_layer(lp: Params, x, cfg: ModelConfig,
              initial_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """Full Mamba-2 block: in-proj → conv → SSD → gated out-proj."""
    cdt = cfg.compute_dtype
    xn = norm(x, lp["norm"], cfg)
    proj = xn @ lp["w_in"].to(cdt)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, lp["conv_w"].to(cdt))
    di, st = cfg.d_inner, cfg.ssm_state
    b, s, _ = xbc.shape
    # x, B and C are strided views of xbc (and .float() of an f32 view is
    # the view): the kernel takes contiguous inputs.
    xh = xbc[..., :di].float().reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim)
    bmat = xbc[..., di:di + st].float().contiguous()
    cmat = xbc[..., di + st:].float().contiguous()
    dt_soft, a = _ssm_inputs(lp, dt)
    y, state = ops.ssd(xh.contiguous(), dt_soft, a, bmat, cmat,
                       cfg.ssm_chunk, initial_state)
    y = y + lp["d_skip"].float()[None, None, :, None] * xh
    out = _gated_out(lp, y.reshape(b, s, di), z, cfg)
    if return_state:
        return x + out, state
    return x + out


def ssd_decode_step(lp: Params, x1, conv_state, ssm_state, cfg: ModelConfig):
    """Single-token decode.  x1: (B,1,D); conv_state: (B,K-1,conv_dim);
    ssm_state: (B,H,P,N).  Returns (y1, new_conv_state, new_ssm_state)."""
    cdt = cfg.compute_dtype
    xn = norm(x1, lp["norm"], cfg)
    proj = xn @ lp["w_in"].to(cdt)
    z, xbc, dt = _split_proj(cfg, proj)
    window = torch.cat([conv_state, xbc], dim=1)              # (B,K,C)
    conv_w = lp["conv_w"].to(cdt)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, conv_w))[:, None]
    di, st = cfg.d_inner, cfg.ssm_state
    xh = conv_out[..., :di].reshape(-1, cfg.ssm_heads,
                                    cfg.ssm_headdim).float()  # (B,H,P)
    bv = conv_out[:, 0, di:di + st].float()                   # (B,N)
    cv = conv_out[:, 0, di + st:].float()
    dt_soft, a = _ssm_inputs(lp, dt[:, 0])
    decay = torch.exp(dt_soft * a)                            # (B,H)
    new_state = ssm_state * decay[..., None, None] + \
        (dt_soft[..., None] * xh)[..., None] * bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", new_state, cv)
    y = y + lp["d_skip"].float()[None, :, None] * xh
    out = _gated_out(lp, y.reshape(x1.shape[0], 1, di), z, cfg)
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


def forward(params: Params, batch: Dict, cfg: ModelConfig):
    """batch: tokens (B,S) on the params' device (positions, if given, are
    not read).  Returns logits (B,S,V) in the compute dtype."""
    # Rows first, then the cast: the same values as casting the table.
    x = params["embed"][batch["tokens"]].to(cfg.compute_dtype)
    # As the reference: only "full" checkpoints; every other policy runs
    # each layer plain.
    remat = torch.is_grad_enabled() and cfg.remat == "full"
    for lp in unstack_layers(params["layers"]):
        if remat:
            x = checkpoint(ssd_layer, lp, x, cfg, use_reentrant=False)
        else:
            x = ssd_layer(lp, x, cfg)
    return unembed(params, x, cfg)


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
    x = params["embed"][tokens].to(cfg.compute_dtype)        # (B,1,D)
    for i, lp in enumerate(unstack_layers(params["layers"])):
        x, conv, ssm = ssd_decode_step(lp, x, cache["conv"][i],
                                       cache["ssm"][i], cfg)
        cache["conv"][i].copy_(conv)
        cache["ssm"][i].copy_(ssm)
    return unembed(params, x, cfg), cache
