"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

One query token per sequence attends to a KV cache stored as fixed-size
pages in a global pool, indirected through a page table.  A CUDA tensor
launches the hand-written kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B, H, D); k/v_pool: (P, page, Hkv, D);
    page_table: (B, n_pages) int32 (−1 = unmapped); lengths: (B,).
    Returns (B, H, D) in q's dtype; rows with lengths == 0 are zeros."""
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must be on one CUDA "
                         "device, or all on the CPU")
    b, h, d = q.shape
    p_total, page_size, hkv, d_kv = k_pool.shape
    if (v_pool.shape != k_pool.shape or d_kv != d or h % hkv
            or d % 8 or d > 256 or page_table.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(
            f"paged_attention: unsupported shapes q{tuple(q.shape)} "
            f"pool{tuple(k_pool.shape)} page_table{tuple(page_table.shape)} "
            f"lengths{tuple(lengths.shape)}")
    if (q.dtype not in _DTYPE_CODES or k_pool.dtype not in _DTYPE_CODES
            or v_pool.dtype != k_pool.dtype
            or page_table.dtype != torch.int32 or lengths.dtype != torch.int32):
        raise TypeError("paged_attention: q and the pools must be float32 or "
                        "bfloat16, page_table and lengths int32")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_attention: inputs must be contiguous and "
                             "16-byte aligned")
    g = h // hkv
    n_pages = page_table.shape[1]
    lib = _lib()
    if lib.paged_attention_smem_bytes(g, d) > _MAX_SMEM:
        raise ValueError("paged_attention: g and D need more shared memory "
                         "than a CTA has")
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = lib.paged_attention(
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, hkv, g, d, n_pages, page_size,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    return out
