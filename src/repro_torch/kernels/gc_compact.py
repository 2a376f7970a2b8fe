"""GC page compaction: the wrapper of ``csrc/gc_compact.cu``.

The host (``ops.compact_units``) turns the page-validity bitmap into one
run-coalesced table of copy units, (src page, dst page, n pages) each; the
kernel is a pure data mover that copies every unit of every plane in one
launch.  A CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain version in ``ref.py``.
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
    fn = lib.gather_page_units
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def gather_page_units(pool, units, out):
    """pool: (..., P, page, D), the leading axes being planes; units:
    (M, 3) host int array of (src page, dst page, n pages).  Pages
    ``src .. src+n`` of every plane are copied to pages ``dst .. dst+n`` of
    ``out`` (..., P_out, page, D), which must not overlap ``pool``; the
    other pages of ``out`` are left as they are.  One launch.  Returns
    ``out``."""
    *planes, p_total, page, d = pool.shape
    units = np.asarray(units, np.int64).reshape(-1, 3)
    if (tuple(out.shape[:-3]) != tuple(planes)
            or tuple(out.shape[-2:]) != (page, d) or out.dtype != pool.dtype):
        raise ValueError(
            f"gather_page_units: bad shapes pool{tuple(pool.shape)} "
            f"out{tuple(out.shape)}")
    src, dst, n = units.T
    if len(units) and (n.min() < 1 or src.min() < 0 or dst.min() < 0
                       or (src + n).max() > p_total
                       or (dst + n).max() > out.shape[-3]):
        raise IndexError("gather_page_units: a unit is out of range")
    if pool.device.type == "cpu" and out.device.type == "cpu":
        src_idx = np.concatenate([np.arange(a, a + k) for a, k in
                                  zip(src, n)] or [np.zeros(0, np.int64)])
        dst_idx = np.concatenate([np.arange(a, a + k) for a, k in
                                  zip(dst, n)] or [np.zeros(0, np.int64)])
        out[..., torch.from_numpy(dst_idx), :, :] = ref.gather_pages_ref(
            pool, torch.from_numpy(src_idx))
        return out
    if pool.device.type != "cuda" or out.device != pool.device:
        raise ValueError("gather_page_units: pool and out must be on one "
                         "CUDA device, or both on the CPU")
    if not pool.is_contiguous() or not out.is_contiguous():
        raise ValueError("gather_page_units: pool and out must be contiguous")
    page_bytes = page * d * pool.element_size()
    n_planes = int(np.prod(planes, dtype=np.int64))
    if page_bytes % 16 or pool.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("gather_page_units: pages must be whole 16-byte "
                         "vectors, 16-byte aligned")
    if len(units) == 0 or n_planes == 0:
        return out
    # Pinned and non-blocking, so the upload does not wait for the stream.
    units_dev = torch.from_numpy(units.astype(np.int32)).pin_memory().to(
        pool.device, non_blocking=True)
    sms = torch.cuda.get_device_properties(pool.device).multi_processor_count
    err = _lib().gather_page_units(
        pool.data_ptr(), out.data_ptr(), units_dev.data_ptr(), len(units),
        n_planes, p_total * page_bytes, out.shape[-3] * page_bytes,
        page_bytes, 2 * sms, torch.cuda.current_stream(pool.device).cuda_stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"gather_page_units kernel launch failed: "
                           f"cudaError {err}")
    return out


def gather_page_blocks(pool, src_block_ids, block_pages: int, out,
                       dst_page: int = 0):
    """pool: (..., P, page, D), the leading axes being planes;
    src_block_ids: (M,) host ids of source blocks of ``block_pages``
    consecutive pages.  Block i of every plane is copied to pages
    ``dst_page + i*block_pages ...`` of ``out`` (..., P_out, page, D), which
    must not overlap ``pool``.  Returns ``out``."""
    *planes, p_total, page, d = pool.shape
    ids = np.asarray(torch.as_tensor(src_block_ids).to("cpu", torch.int64))
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
    units = np.stack([ids * block_pages,
                      dst_page + np.arange(m) * block_pages,
                      np.full(m, block_pages)], axis=1)
    return gather_page_units(pool, units, out)
