"""The hand-written kernels' least work, and the cost counter that their
meta branches feed.

Each ``*_flops_bytes`` gives the operations a kernel's function needs and
the bytes it must move (each input read once, each output written once),
from shapes: ``chip_smoke.py`` divides them by the card's peaks for each
kernel's bound, and a wrapper given meta tensors adds them to the active
``Cost`` (the dry-run's), in place of the work it does not do.  The
peaks are the published H100 SXM data-sheet figures (dense, at the 700 W
power limit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 outside the
# tensor cores, dense TF32 and bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12


def paged_attention_flops_bytes(b, h, hkv, d, tokens, n_pages, q_bytes,
                                kv_bytes):
    """K1: q read and the output written (B, H, D), the K and V rows of
    ``tokens`` context tokens read, the page table (B, n_pages) and the
    lengths (int32) read; a dot and an FMA per (token, head, d) for the
    scores and for P·V."""
    nbytes = (2 * b * h * d * q_bytes + 2 * tokens * hkv * d * kv_bytes
              + b * n_pages * 4 + b * 4)
    return 4 * tokens * h * d, nbytes


def gather_flops_bytes(pages, units, planes, page, d, elem_bytes):
    """K2: ``pages`` pages of every plane read and written once, and one
    int32 a copy unit; no arithmetic."""
    return 0, 2 * pages * planes * page * d * elem_bytes + units * 4


def flash_attention_flops_bytes(b, s, h, hkv, d, elem_bytes, causal=True,
                                with_lse=False):
    """K3: q, k and v read once, the output (q's size) and, for a
    gradient, each row's log-sum-exp (f32) written once; two products of
    2 d flops per (query, key) pair, s(s+1)/2 pairs of a head under
    causal masking, s² without."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * elem_bytes
    if with_lse:
        nbytes += b * h * s * 4
    return 4 * b * h * d * pairs, nbytes


def attention_bwd_flops_bytes(q, k, causal=True):
    """K3-bwd's least work: five products of the forward's size (S = Q Kᵀ,
    dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K, dK = dSᵀ Q), each 2 b h d s(s+1)/2
    flops under causal masking (s² pairs without); and its bytes: q, k, v,
    o, dO and lse read once, dq, dk and dv written once."""
    b, s, h, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 5 * 2 * b * h * d * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + b * h * s * 4
    return flops, nbytes


def ssd_flops_bytes(b, s, h, p, n, with_state):
    """The SSD scan's least work: whatever the chunking, each step's
    (x dt) outer B enters the (P, N) state and each step's y reads the state
    through C, one FMA each per state entry (4 P N flops per (b, step, h));
    the chunked form's intra-chunk triangle comes on top, so it is not
    counted.  And its bytes: each f32 input read once and each output
    written once."""
    flops = 4 * b * s * h * p * n
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + h
                  + b * h * p * n * (2 if with_state else 1))
    return flops, nbytes


def ssd_bwd_flops_bytes(b, s, h, p, n, chunk, with_state, with_dfinal):
    """K4-bwd's least work: each of the forward's two products per (b, step,
    h) and state entry (x dt outer B into the state, C through the state)
    has a gradient for each of its operands, so twice the forward's, 8 P N
    flops per (b, step, h).  And its bytes: x, dt, a, B, C, dy, the
    forward's states and sums of dA (its workspace), the initial state and
    dfinal where given, each read once; dx, ddt, da, dB, dC and dinit
    written once."""
    nc = s // chunk
    flops = 8 * b * s * h * p * n
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 2 * h + 4 * b * s * n
                  + b * h * nc * (p * n + 1)
                  + b * h * p * n * (2 * with_state + with_dfinal))
    return flops, nbytes


@dataclasses.dataclass
class Cost:
    """Flops and bytes of the kernels that ran on meta tensors inside
    ``counting``, by kernel."""

    flops: int = 0
    bytes: int = 0
    calls: dict = dataclasses.field(default_factory=dict)


_state = threading.local()


@contextlib.contextmanager
def counting(cost: Cost):
    """Make ``cost`` the counter that meta kernel calls add to."""
    prev = getattr(_state, "cost", None)
    _state.cost = cost
    try:
        yield cost
    finally:
        _state.cost = prev


def add(kernel: str, flops: int, nbytes: int) -> None:
    """A kernel's meta branch: its formula's work, to the active counter
    (none: nothing)."""
    cost = getattr(_state, "cost", None)
    if cost is None:
        return
    cost.flops += flops
    cost.bytes += nbytes
    cost.calls[kernel] = cost.calls.get(kernel, 0) + 1
