"""The least work of the kernels the benchmark reports a roofline share of
(``gpubench/kernels/<kernel>.py`` say which formula each takes), and the
model flops of a step.

A frozen copy, kept with the benchmark: the program's own formulas may
change, these may not.  Each formula counts what the operation needs,
whatever implements it: each product once, each input byte read once and
each output byte written once.  A kernel's bound is the larger of its flops
over the peak of the dtype its products take and its bytes over the HBM
rate (``bound_s``).
"""

from __future__ import annotations

from .families import family

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).  F32
# products: the card's fastest rate for products of f32 operands is its
# TF32 tensor-core rate, so no implementation of an f32 product can pass
# it; the f32 rate outside the tensor cores (67 TFLOP/s) is below what a
# split-TF32 kernel reaches, and would let a share pass 100%.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
MFU_PEAK_FLOPS = 989e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of ``flops`` products in ``dtype`` that move
    ``nbytes``."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def attention_fwd(b, s, h, hkv, d, elem_bytes, with_lse):
    """Causal attention forward (K3): q, k, v read, the output written, and
    for a gradient each row's f32 log-sum-exp; two products of 2 d flops
    per (query, key) pair, s(s+1)/2 pairs of a head."""
    pairs = s * (s + 1) // 2
    nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * elem_bytes
    if with_lse:
        nbytes += b * h * s * 4
    return 4 * b * h * d * pairs, nbytes


def attention_bwd(b, s, h, hkv, d, elem_bytes):
    """Causal attention backward (K3-bwd): five products of the forward's
    size (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K, dK = dSᵀ Q); q, o,
    dO and dq of (b, s, h, d), k, v, dk and dv of (b, s, hkv, d), and the
    f32 log-sum-exp."""
    pairs = s * (s + 1) // 2
    flops = 5 * 2 * b * h * d * pairs
    nbytes = (4 * b * s * h * d + 4 * b * s * hkv * d) * elem_bytes \
        + b * h * s * 4
    return flops, nbytes


def ssd_fwd(b, s, h, p, n):
    """The SSD scan (K4), f32: each step's (x dt) outer B enters the (P, N)
    state and each step's y reads the state through C, one FMA each per
    state entry; x, y (b, s, h, p), B, C (b, s, n), dt (b, s, h) and a (h)
    read or written once, and the final state (b, h, p, n) written."""
    flops = 4 * b * s * h * p * n
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + h
                  + b * h * p * n)
    return flops, nbytes


def ssd_bwd(b, s, h, p, n):
    """The SSD scan's backward (K4-bwd), f32: a gradient for each operand
    of the forward's two products, twice the forward's flops; x, dy, dx
    (b, s, h, p), dt, ddt (b, s, h), B, C, dB, dC (b, s, n), a and da (h)
    read or written once.  What an implementation keeps between the passes
    is its own choice and is not counted."""
    flops = 8 * b * s * h * p * n
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n + 2 * h)
    return flops, nbytes


def model_flops(cfg: dict, batch: int, seq: int, train: bool) -> float:
    """A step's model flops: 2 per matrix parameter and token forward (6 to
    train), and the sequence mixing's own count (the family's
    ``mixer_flops``: causal attention's 2·s²·d a layer and sequence, or
    the SSD scan's).  Recomputation is not counted."""
    fam = family(cfg)
    mult = 3 if train else 1
    return float(2 * mult * fam.matrix_params(cfg) * batch * seq
                 + fam.mixer_flops(cfg, batch, seq, train))
