"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

One query token per sequence attends to a KV cache stored as fixed-size
pages in a global pool, indirected through a page table.  A CUDA tensor
launches the hand-written kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``; a meta tensor does no work and adds the kernel's
least work (``cost.py``) to the active cost counter.  The kernel splits
each sequence's padded context across CTAs (flash-decoding) and merges the
splits in the same launch; ``plan_splits`` plans the split on the host,
from shapes alone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, cost, ref

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024
# The split plan: a CTA takes one split of a (sequence, kv head)'s padded
# context; the plan aims at CTAS_PER_SM CTAs an SM, with splits of at
# least MIN_SPLIT_TOKENS tokens (one split below it) and at most
# MAX_SPLIT_PAGES pages (the page-table slice a CTA keeps in shared
# memory).  MAX_SPLITS only raises the pages a split takes, so that up to
# MAX_SPLITS * MAX_SPLIT_PAGES pages there are at most MAX_SPLITS splits
# (the merge keeps two floats a split and head in shared memory); a longer
# context takes more, and the shared-memory check bounds the merge.
CTAS_PER_SM = 16
MIN_SPLIT_TOKENS = 128
MAX_SPLITS = 64
MAX_SPLIT_PAGES = 1024
# Arrival counters of the in-launch merge, one buffer per (device, stream):
# zeroed once when made and left at zero by every launch, so calls in
# flight on different streams never share a counter.
_counters = {}


def plan_splits(n_pages: int, page_size: int, batch: int, hkv: int,
                n_sms: int):
    """How K1 cuts each sequence's padded context (``n_pages * page_size``
    tokens): returns (pages_per_split, n_splits), each split a whole number
    of pages.  Shapes only: ``lengths`` is never read back from the card."""
    want = -(-CTAS_PER_SM * n_sms // max(batch * hkv, 1))
    pages = -(-n_pages // want)
    pages = max(pages, -(-MIN_SPLIT_TOKENS // page_size),
                -(-n_pages // MAX_SPLITS))
    pages = max(1, min(pages, MAX_SPLIT_PAGES, n_pages))
    return pages, max(1, -(-n_pages // pages))


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_partial_floats.argtypes = [ctypes.c_int] * 2
        lib.paged_attention_partial_floats.restype = ctypes.c_int
    return lib


def _arrival_counters(device, stream: int, n: int):
    # Made on `stream`, so growing it frees the old buffer only once the
    # stream's earlier launches are done with it.
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B, H, D); k/v_pool: (P, page, Hkv, D);
    page_table: (B, n_pages) int32 (−1 = unmapped); lengths: (B,).
    Returns (B, H, D) in q's dtype; rows with lengths == 0 are zeros.
    Meta tensors return an empty output and add the kernel's least work,
    every sequence taken at its whole page table, to the cost counter.

    On the card the call runs on the current stream, with arrival counters
    of that stream's own: calls on different streams may overlap."""
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if any(t.device != q.device for t in tensors) \
            or q.device.type not in ("cuda", "meta"):
        raise ValueError("paged_attention: all tensors must be on one CUDA "
                         "device, or all on the CPU, or all on meta")
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
    if q.device.type == "meta":
        # no lengths to read: every sequence at its whole page table
        cost.add("paged_attention", *cost.paged_attention_flops_bytes(
            b, h, hkv, d, b * n_pages * page_size, n_pages,
            q.element_size(), k_pool.element_size()))
        return torch.empty_like(q)
    pages_per_split, splits = plan_splits(
        n_pages, page_size, b, hkv,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    lib = _lib()
    if lib.paged_attention_smem_bytes(g, d, k_pool.element_size(),
                                      pages_per_split, splits, 1) > _MAX_SMEM:
        raise ValueError("paged_attention: g and D need more shared memory "
                         "than a CTA has")
    out = torch.empty_like(q)
    if b == 0:
        return out
    ws = (torch.empty(b * hkv * splits
                      * lib.paged_attention_partial_floats(g, d),
                      dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _arrival_counters(q.device, stream, b * hkv)
    err = lib.paged_attention(
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), counters.data_ptr(), b, hkv,
        g, d, n_pages, page_size, pages_per_split, splits,
        1.0 / math.sqrt(d), stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    return out
