"""Flash attention: the wrappers of ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward).

Causal or full GQA attention over a whole sequence with a streaming
softmax, so the (S, S) score matrix is never stored.  A CUDA tensor
launches the hand-written kernels (or raises); a CPU tensor runs the plain
versions in ``ref.py``; a meta tensor does no work: it returns empty
outputs of the kernel's shapes and adds the kernel's least work
(``cost.py``) to the active cost counter.  Where a gradient is wanted, the
call goes through a ``torch.autograd.Function``: its forward also keeps
each row's log-sum-exp, and its backward is the backward kernel (or, for
CPU tensors, ``ref.flash_attention_bwd_ref``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, cost, ref

# Kernel launches since the last reset; chip_smoke.py reads them.
# ``launches`` counts forward kernels, ``bwd_launches`` backward calls (each
# one runs the backward's three kernels).
launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        work = lib.flash_attention_bwd_workspace
        work.argtypes = [ctypes.c_int] * 6
        work.restype = ctypes.c_longlong
    return lib


def _check(tensors):
    """(B, S, H, Hkv, D) of q, k, v = tensors[:3]; raises unless every
    tensor lies on one CUDA device (or all on meta), the shapes and dtype
    are the kernels', and every tensor is contiguous and 16-byte
    aligned."""
    q, k, v = tensors[:3]
    shapes = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
    if any(t.device != q.device for t in tensors) \
            or q.device.type not in ("cuda", "meta"):
        raise ValueError("flash_attention: all tensors must be on one CUDA "
                         "device, or all on the CPU, or all on meta")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes {shapes}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if (k.shape[:2] != (b, s) or k.shape[3] != d or hkv == 0 or h % hkv
            or d % 8 or not 0 < d <= 256):
        raise ValueError(f"flash_attention: unsupported shapes {shapes}: "
                         "need H % Hkv == 0 and D a multiple of 8 up to 256")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must all be float32 or "
                        "all bfloat16")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous and "
                             "16-byte aligned")
    return b, s, h, hkv, d


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(out, lse or None); lse (B, H, S) f32, only when ``with_lse``."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        if with_lse:
            return ref.flash_attention_ref(q, k, v, causal, return_lse=True)
        return ref.flash_attention_ref(q, k, v, causal), None
    b, s, h, hkv, d = _check((q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        cost.add("flash_attention", *cost.flash_attention_flops_bytes(
            b, s, h, hkv, d, q.element_size(), causal, with_lse))
        return out, lse
    if out.numel() == 0:
        return out, lse
    err = _lib().flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h, hkv,
        d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v), given
    its output ``out``, its log-sum-exp ``lse`` (B, H, S) f32 and the
    output's gradient ``dout`` (q's shape and dtype).  CPU tensors run
    ``ref.flash_attention_bwd_ref``; CUDA tensors the backward kernel; meta
    tensors give empty gradients and add the kernel's least work to the
    cost counter."""
    tensors = (q, k, v, out, lse, dout)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    b, s, h, hkv, d = _check(tensors)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and dout must have q's "
                         "shape and dtype")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be ({b}, {h}, {s}) "
                         f"float32, got {lse.dtype}{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.device.type == "meta":
        cost.add("flash_attention_bwd",
                 *cost.attention_bwd_flops_bytes(q, k, causal))
        return dq, dk, dv
    if q.numel() == 0:
        return dq, dk, dv
    lib, dtype = _bwd_lib(), _DTYPE_CODES[q.dtype]
    # Scratch: each row's delta, then any partial sums of dk and dv.
    work = torch.empty(
        (lib.flash_attention_bwd_workspace(dtype, b, s, h, hkv, d),),
        dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd(
        dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), work.data_ptr(), b, s, h, hkv, d,
        int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    global bwd_launches
    bwd_launches += 1
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K3 with its gradient: the forward kernel, keeping ``lse`` only when a
    gradient is asked for, and the backward kernel.  Under non-reentrant
    checkpointing the forward runs again in the backward pass, and saves
    ``lse`` then too."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        with_lse = any(ctx.needs_input_grad[:3])
        out, lse = _forward(q, k, v, causal, with_lse)
        if with_lse:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D), H % Hkv == 0, all float32 or
    all bfloat16.  Returns (B, S, H, D) in q's dtype; ``sm_scale = 1/√D``;
    query head h reads KV head h // (H // Hkv).  Differentiable: with grad
    enabled and an input that requires it, the call goes through
    ``FlashAttention``; otherwise the forward kernel alone runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]
