"""Flash attention: the wrapper of ``csrc/flash_attention.cu``.

Causal or full GQA attention over a whole sequence with a streaming
softmax, so the (S, S) score matrix is never stored.  A CUDA tensor
launches the hand-written kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.  There is no backward kernel: the wrapper refuses
inputs that would need a gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D), H % Hkv == 0, all float32 or
    all bfloat16.  Returns (B, S, H, D) in q's dtype; ``sm_scale = 1/√D``;
    query head h reads KV head h // (H // Hkv)."""
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("flash_attention: all tensors must be on one CUDA "
                         "device, or all on the CPU")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("flash_attention: the kernel has no backward; "
                           "call it under torch.no_grad() or on inputs that "
                           "do not require grad")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if (k.shape[:2] != (b, s) or k.shape[3] != d or hkv == 0 or h % hkv
            or d % 8 or not 0 < d <= 256):
        raise ValueError(f"flash_attention: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}: need "
                         "H % Hkv == 0 and D a multiple of 8 up to 256")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must all be float32 or "
                        "all bfloat16")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous and "
                             "16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, hkv, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return out
