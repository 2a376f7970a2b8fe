"""GC page compaction: the wrapper of ``csrc/gc_compact.cu``.

The host (``ops.compact_plan``) turns the page-validity bitmap into a
run-coalesced copy plan at a fixed block granularity; the kernel is a pure
data mover that copies each planned block of every plane in one launch.  A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, ref

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


def _lib():
    lib = _build.load("gc_compact")
    fn = lib.gather_page_blocks
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def gather_page_blocks(pool, src_block_ids, block_pages: int, out,
                       dst_page: int = 0):
    """pool: (..., P, page, D), the leading axes being planes;
    src_block_ids: (M,) host ids of source blocks of ``block_pages``
    consecutive pages.  Block i of every plane is copied to pages
    ``dst_page + i*block_pages ...`` of ``out`` (..., P_out, page, D), which
    must not overlap ``pool``.  Returns ``out``."""
    *planes, p_total, page, d = pool.shape
    ids = torch.as_tensor(src_block_ids).to("cpu", torch.int32)
    m = ids.shape[0]
    if (p_total % block_pages or tuple(out.shape[:-3]) != tuple(planes)
            or tuple(out.shape[-2:]) != (page, d) or out.dtype != pool.dtype
            or dst_page < 0 or dst_page + m * block_pages > out.shape[-3]):
        raise ValueError(
            f"gather_page_blocks: bad shapes pool{tuple(pool.shape)} "
            f"out{tuple(out.shape)} block_pages={block_pages} "
            f"dst_page={dst_page} m={m}")
    if m and (int(ids.min()) < 0 or int(ids.max()) >= p_total // block_pages):
        raise IndexError("gather_page_blocks: source block id out of range")
    if pool.device.type == "cpu" and out.device.type == "cpu":
        idx = (ids[:, None] * block_pages + torch.arange(block_pages)).reshape(-1)
        out[..., dst_page:dst_page + idx.shape[0], :, :] = \
            ref.gather_pages_ref(pool, idx)
        return out
    if pool.device.type != "cuda" or out.device != pool.device:
        raise ValueError("gather_page_blocks: pool and out must be on one "
                         "CUDA device, or both on the CPU")
    if not pool.is_contiguous() or not out.is_contiguous():
        raise ValueError("gather_page_blocks: pool and out must be contiguous")
    page_bytes = page * d * pool.element_size()
    n_planes = int(np.prod(planes, dtype=np.int64))
    if (page_bytes % 16 or pool.data_ptr() % 16 or out.data_ptr() % 16
            or n_planes > 65535):
        raise ValueError("gather_page_blocks: pages must be whole 16-byte "
                         "vectors, 16-byte aligned, in at most 65535 planes")
    if m == 0 or n_planes == 0:
        return out
    # Pinned and non-blocking, so the upload does not wait for the stream.
    ids_dev = ids.pin_memory().to(pool.device, non_blocking=True)
    err = _lib().gather_page_blocks(
        pool.data_ptr(), out.data_ptr(), ids_dev.data_ptr(), m, n_planes,
        p_total * page_bytes, out.shape[-3] * page_bytes,
        block_pages * page_bytes, dst_page * page_bytes,
        torch.cuda.current_stream(pool.device).cuda_stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"gather_page_blocks kernel launch failed: "
                           f"cudaError {err}")
    return out
