"""Public entry points over the hand-written kernels.

The tensors' device picks the path: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version in ``ref.py``, a meta tensor
does no work and adds the kernel's least work (``cost.py``) to the active
cost counter.  There is no switch and no fall back.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .flash_attention import flash_attention
from .gc_compact import gather_page_units
from .paged_attention import paged_attention
from . import ssd_fused
from .ssd_scan import ssd_scan


def attention(q, k, v, causal: bool = True):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) → (B, S, H, D).  Where a
    gradient is wanted it goes through ``FlashAttention`` (the forward and
    backward kernels on the card)."""
    return flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_pool, v_pool, page_table, lengths):
    return paged_attention(q, k_pool, v_pool, page_table, lengths)


def ssd(x, dt, a, bmat, cmat, chunk: int, initial_state=None):
    """Mamba-2 SSD scan.  x: (B,S,H,P) dt: (B,S,H) a: (H,) bmat/cmat:
    (B,S,N) → (y (B,S,H,P), final_state (B,H,P,N) float32)."""
    return ssd_scan(x, dt, a, bmat, cmat, chunk, initial_state)


_OWN_SSD = ssd


def ssd_mixer(proj, conv_w, dt_bias, a_log, d_skip, out_norm, initial_state,
              widths):
    """The Mamba-2 layer between its two projections, on the packed
    in-projection output (``ssd_fused.ssd_mixer`` says what it takes and
    gives).  Its scan is ``ssd`` above, the one seam of the scan: while
    ``ssd`` is this module's own, the fused kernels run around K4; a run
    that sets ``ssd`` to another scan (a plain or f64 reference) gets the
    whole stretch plain around that scan (``ssd_fused.ssd_mixer_ref``), so
    swapping the scan alone can never leave K4 in place."""
    run = (ssd_fused.ssd_mixer if ssd is _OWN_SSD
           else ssd_fused.ssd_mixer_ref)
    return run(proj, conv_w, dt_bias, a_log, d_skip, out_norm,
               initial_state, widths)


# --------------------------------------------------------------------------
# GC compaction planning (host side) + kernel dispatch
# --------------------------------------------------------------------------

def compact_plan(valid: np.ndarray, block_pages: int
                 ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """Turn a page-validity bitmap into a run-coalesced copy plan.

    Returns (block_src_ids, tail_page_ids, runs):
    * ``block_src_ids`` — source *block* indices (block_pages-aligned runs
      of live pages) to move with one large copy each;
    * ``tail_page_ids`` — leftover live pages moved at single-page
      granularity;
    * ``runs`` — [(start, length)] of the detected live runs (for stats:
      copy count = len(block_src_ids) + len(tail_page_ids) vs
      valid.sum() without coalescing — the paper's Fig. 10 arithmetic).
    """
    valid = np.asarray(valid, bool)
    runs: List[Tuple[int, int]] = []
    i = 0
    n = len(valid)
    while i < n:
        if not valid[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and valid[j + 1]:
            j += 1
        runs.append((i, j - i + 1))
        i = j + 1
    blocks: List[int] = []
    tail: List[int] = []
    for start, length in runs:
        # aligned full blocks inside the run
        first_block = -(-start // block_pages)          # ceil
        last_block = (start + length) // block_pages
        for b in range(first_block, last_block):
            blocks.append(b)
        covered = set(range(first_block * block_pages,
                            last_block * block_pages))
        for p in range(start, start + length):
            if p not in covered:
                tail.append(p)
    return (np.asarray(blocks, np.int32), np.asarray(tail, np.int32), runs)


def compact_units(valid, block_pages: int
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The copy plan of one compaction as one table of units.

    Returns (units, new_index, dma_count): ``units`` (M, 3) int32 rows of
    (src page, dst page, n pages), the aligned blocks of ``compact_plan``
    first, then its single-page tails, at consecutive destinations from
    page 0; ``new_index[i]`` the destination of old page i (−1 if dropped);
    ``dma_count`` the copies per plane (blocks + tails).
    """
    valid_np = np.asarray(valid, bool)
    blocks, tail, _ = compact_plan(valid_np, block_pages)
    src = np.concatenate([blocks.astype(np.int64) * block_pages,
                          tail.astype(np.int64)])
    n = np.concatenate([np.full(len(blocks), block_pages, np.int64),
                        np.ones(len(tail), np.int64)])
    dst = np.cumsum(n) - n
    units = np.stack([src, dst, n], axis=1).astype(np.int32)
    new_index = np.full(len(valid_np), -1, np.int32)
    for s_page, d_page, k in units:
        new_index[s_page:s_page + k] = np.arange(d_page, d_page + k)
    return units, new_index, len(units)


def compact_pages(pool, valid, block_pages: int = 4, out=None):
    """Compact live pages to the front of a pool, run-coalesced.

    pool: (..., P, page, D), every leading (plane) index moved with the same
    plan.  Live pages land in plan order (aligned blocks, then single-page
    tails) at the front of ``out``; pages of ``out`` past the live count are
    left as they are (default ``out``: a zero pool, as the JAX package
    returns).  Always issues the coalesced plan, whatever the device: one
    launch for the whole plan.

    Returns (out, new_index, dma_count) where ``new_index[i]`` (a host int32
    array) is the destination slot of old page i (−1 if dropped) and
    ``dma_count`` is the number of block copies per plane.
    """
    units, new_index, dmas = compact_units(valid, block_pages)
    if out is None:
        out = torch.zeros_like(pool)
    if len(units):
        gather_page_units(pool, units, out)
    return out, new_index, dmas
