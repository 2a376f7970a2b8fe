"""The plain reference: the parts that every model family shares, and the
model itself, whose layers each family gives (``families/<family>.py``),
written from their published descriptions in plain PyTorch, in float32
with TF32 off.

Every family reads the benchmark's weights (``gpubench.weights``) by the
same leaf names the program uses, and nothing of the program.
``Precision`` says how the products are taken: in f32 for the reference,
or, for the control that a check has to fail, with the operands rounded to
the next precision below the configuration's (``Precision.control``).

To keep memory in bounds, callers feed it one row at a time.
"""

from __future__ import annotations

from typing import Optional

import torch

from .families import family

FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def f32_mode() -> None:
    """Products in true f32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    """x rounded to a float8 format under one scale for the tensor (its
    largest magnitude at the format's largest value), back in f32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(fmt).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Operands of a product in float8, as fp8 training takes them: e4m3
    forward, and the gradient that flows back through them in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), in f32."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # the rounding as a value added to x: the gradient passes unchanged
    return x + (rounded - x.detach())


class Precision:
    """How the reference takes its products.  ``products`` rounds the
    operands of the model's products (those the configuration computes in
    its compute dtype), ``scan`` those of the SSD scan's (computed in f32
    by the configuration)."""

    def __init__(self, products=None, scan=None):
        self.products = products
        self.scan = scan

    @classmethod
    def reference(cls):
        return cls()

    @classmethod
    def control(cls):
        """One step below the configuration: bf16 products in fp8, the
        f32 scan in TF32."""
        return cls(_fp8, _tf32)

    def einsum(self, eq: str, a, b):
        if self.products is not None:
            a, b = self.products(a), self.products(b)
        return torch.einsum(eq, a, b)

    def scan_einsum(self, eq: str, *xs):
        if self.scan is not None:
            xs = [self.scan(x) for x in xs]
        return torch.einsum(eq, *xs)


# --------------------------------------------------------------------------
# Shared parts
# --------------------------------------------------------------------------

def layernorm(x, eps: float):
    """Non-parametric LayerNorm (no gain, no bias), as OLMo's."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rmsnorm(x, gain, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain


def rope(x, positions, theta: float):
    """Rotary embedding of interleaved pairs (x[..., 0::2], x[..., 1::2]).
    x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    i = torch.arange(0, d, 2, dtype=torch.float64, device=x.device)
    freqs = (1.0 / theta ** (i / d)).float()
    ang = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def token_losses(logits, targets):
    """Next-token cross-entropy of each position, f32."""
    return torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, targets.long()[..., None])[..., 0]


def layer_weights(w: dict, i: int) -> dict:
    """Layer ``i``'s slice of every stacked leaf, by its name in the
    layer."""
    return {k[len("layers."):]: v[i] for k, v in w.items()
            if k.startswith("layers.")}


def run_layers(w: dict, tokens, cfg: dict, prec: Precision, layer):
    """The embedding of ``tokens`` (B, S) through ``cfg["n_layers"]``
    calls of ``layer(x, layer_weights, positions, cfg, prec)``."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = w["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = layer(x, layer_weights(w, i), positions, cfg, prec)
    return x


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

def hidden(w: dict, tokens, cfg: dict, prec: Precision):
    """The last layer's output after the final norm, f32, by the
    configuration's family (``families/<family>.py``).  w: {leaf name: f32
    tensor}; tokens (B, S)."""
    return family(cfg).hidden(w, tokens, cfg, prec)


def logits(w: dict, h, prec: Precision):
    """The unembedding of the final-normed hidden state ``h``."""
    return prec.einsum("bsd,dv->bsv", h, w["unembed"])


def last_logits(w: dict, tokens, cfg: dict,
                prec: Optional[Precision] = None):
    """The last position's logits (B, V), f32, without a gradient."""
    prec = prec or Precision.reference()
    with torch.no_grad():
        h = hidden(w, tokens, cfg, prec)
        return logits(w, h[:, -1:], prec)[:, 0]
