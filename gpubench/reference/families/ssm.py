"""Mamba-2: RMSNorm, in-projection to (z, x, B, C, dt), causal depthwise
conv and SiLU over (x, B, C), the SSD scan (one group of B and C for all
heads), the skip D·x, gating by SiLU(z), RMSNorm, out-projection; a final
RMSNorm and an untied unembedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import cost
from ..models import rmsnorm, run_layers
from . import stacked


def _heads(cfg: dict):
    di = cfg["expand"] * cfg["d_model"]
    return di, di // cfg["headdim"], cfg["headdim"], cfg["d_state"]


def leaves(cfg: dict):
    d = cfg["d_model"]
    di, nh, _, n = _heads(cfg)
    k = cfg["d_conv"]
    return stacked(cfg, [("final_norm", (d,), "ones", 0.0)], [
        ("norm", (d,), "ones", 0.0),
        ("w_in", (d, 2 * di + 2 * n + nh), "normal", d ** -0.5),
        ("conv_w", (k, di + 2 * n), "normal", k ** -0.5),
        ("a_log", (nh,), "a_log", 0.0),
        ("d_skip", (nh,), "ones", 0.0),
        ("dt_bias", (nh,), "dt_bias", 0.0),
        ("out_norm", (di,), "ones", 0.0),
        ("w_out", (di, d), "normal", di ** -0.5)])


def segsum(a):
    """(..., T) -> (..., T, T): Σ a[j+1..i] at [i, j] for j ≤ i, -inf
    above the diagonal."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~below, 0.0).cumsum(dim=-2)
    upto = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return x.masked_fill(~upto, float("-inf"))


def ssd(x, dt, a, bmat, cmat, chunk: int, prec):
    """The SSD scan, chunked: state_t = exp(dt_t a) state_{t-1} + (dt_t x_t)
    ⊗ B_t, y_t = state_t · C_t, from a zero state.  x (b, s, h, p), dt
    (b, s, h), a (h), B and C (b, s, n); returns y (b, s, h, p)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    c = s // chunk
    xd = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    da = (dt * a).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # b h c l
    bm = bmat.reshape(b, c, chunk, n)
    cm = cmat.reshape(b, c, chunk, n)
    cum = torch.cumsum(da, dim=-1)
    decay = torch.exp(segsum(da))                               # b h c l l
    scores = prec.scan_einsum("bcln,bcsn->bcls", cm, bm)
    y_diag = prec.scan_einsum("bhcls,bcshp->bclhp",
                              decay * scores[:, None], xd)
    to_end = torch.exp(cum[..., -1:] - cum)                     # b h c l
    states = prec.scan_einsum("bcln,bclhp->bchpn", bm,
                              xd * to_end.permute(0, 2, 3, 1)[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = prec.scan_einsum("bcln,bchpn->bclhp", cm, states) \
        * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p)


def causal_conv(x, w):
    """Depthwise causal conv along the sequence: x (b, s, c), w (k, c)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(k))


def layer(x, lw: dict, positions, cfg: dict, prec):
    eps = cfg["norm_eps"]
    di, nh, hp, n = _heads(cfg)
    b, s, _ = x.shape
    proj = prec.einsum("bsd,de->bse", rmsnorm(x, lw["norm"], eps),
                       lw["w_in"])
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]
    xbc = F.silu(causal_conv(xbc, lw["conv_w"]))
    xh = xbc[..., :di].reshape(b, s, nh, hp)
    bmat, cmat = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + lw["dt_bias"])
    y = ssd(xh, dt, -torch.exp(lw["a_log"]), bmat, cmat, cfg["chunk_size"],
            prec)
    y = y + lw["d_skip"][:, None] * xh
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), lw["out_norm"], eps)
    return x + prec.einsum("bse,ed->bsd", y, lw["w_out"])


def hidden(w: dict, tokens, cfg: dict, prec):
    x = run_layers(w, tokens, cfg, prec, layer)
    return rmsnorm(x, w["final_norm"], cfg["norm_eps"])


def matrix_params(cfg: dict) -> int:
    d = cfg["d_model"]
    di, nh, _, n = _heads(cfg)
    w_in = d * (2 * di + 2 * n + nh)
    return cfg["n_layers"] * (w_in + di * d) + d * cfg["vocab"]


def mixer_flops(cfg: dict, batch: int, seq: int, train: bool) -> float:
    """The SSD scan's own count a layer (its backward's on top to
    train)."""
    _, nh, hp, n = _heads(cfg)
    flops = cost.ssd_fwd(batch, seq, nh, hp, n)[0]
    if train:
        flops += cost.ssd_bwd(batch, seq, nh, hp, n)[0]
    return flops * cfg["n_layers"]
