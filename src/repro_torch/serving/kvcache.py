"""Paged KV-cache manager — Scavenger+ on device-memory pages.

Mapping of the paper's structures onto the serving tier:

  value store (vSSTs)   → per-layer K/V page pools in device memory
  index LSM-tree        → host page table (seq_id → page list)
  garbage               → pages of finished/evicted sequences
  hot/cold vSSTs        → ACTIVE vs FROZEN (paused/beam) sequence pools
  exposed-garbage ratio → free-list fragmentation of the pool
  GC (lazy read + adaptive readahead)
                        → run-coalesced live-page compaction
                          (kernels/gc_compact; one copy per live block)

The host allocator is the JAX package's, bug for bug; the pool is a torch
tensor on ``PagedCacheConfig.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..models.config import ModelConfig


@dataclasses.dataclass
class PagedCacheConfig:
    n_pages: int
    page_size: int = 16
    compact_block_pages: int = 4
    device: str = "cuda"


class PagedKVCache:
    """Host-managed page table over device K/V pools for one layer stack."""

    def __init__(self, cfg: ModelConfig, pc: PagedCacheConfig) -> None:
        self.cfg = cfg
        self.pc = pc
        self.device = resolve_device(pc.device)
        shape = (cfg.n_layers, 2, pc.n_pages, pc.page_size,
                 cfg.kv_heads, cfg.head_dim)
        self.pool = torch.zeros(shape, dtype=cfg.compute_dtype,
                                device=self.device)
        self.free: List[int] = list(range(pc.n_pages - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}      # seq -> page ids
        self.lengths: Dict[int, int] = {}
        self.frozen: Dict[int, bool] = {}           # cold sequences
        self.compactions = 0
        self.compaction_dmas = 0
        self.alloc_failures = 0

    # -- space accounting (paper eq. 5 analog) ---------------------------
    @property
    def used_pages(self) -> int:
        return sum(len(v) for v in self.tables.values())

    @property
    def free_pages(self) -> int:
        return len(self.free)

    def fragmentation(self) -> float:
        """Exposed-garbage analog: fraction of the *allocated prefix* of
        the pool that is free (holes blocking contiguous growth)."""
        if not self.tables:
            return 0.0
        hi = max((max(t) for t in self.tables.values() if t), default=-1)
        if hi < 0:
            return 0.0
        live = self.used_pages
        return 1.0 - live / (hi + 1)

    # -- allocation -------------------------------------------------------
    def add_sequence(self, seq_id: int, prompt_len: int) -> bool:
        n = -(-max(prompt_len, 1) // self.pc.page_size)
        if len(self.free) < n:
            self.alloc_failures += 1
            return False
        self.tables[seq_id] = [self.free.pop() for _ in range(n)]
        self.lengths[seq_id] = prompt_len
        self.frozen[seq_id] = False
        return True

    def append_token(self, seq_id: int) -> bool:
        """Reserve room for one more token; grabs a new page on boundary."""
        ln = self.lengths[seq_id]
        # Same precedence as the JAX package: (a and b) or c.
        if ln % self.pc.page_size == 0 and ln > 0 or \
                ln == self.pc.page_size * len(self.tables[seq_id]):
            if not self.free:
                self.alloc_failures += 1
                return False
            self.tables[seq_id].append(self.free.pop())
        self.lengths[seq_id] = ln + 1
        return True

    def finish_sequence(self, seq_id: int) -> None:
        """Completion turns the sequence's pages into reclaimable garbage
        (freed immediately — 'exposed'); fragmentation may remain."""
        for p in self.tables.pop(seq_id, []):
            self.free.append(p)
        self.lengths.pop(seq_id, None)
        self.frozen.pop(seq_id, None)

    def freeze(self, seq_id: int, frozen: bool = True) -> None:
        self.frozen[seq_id] = frozen

    # -- device-side views -------------------------------------------------
    def page_table_array(self, seq_ids: List[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        max_pages = max((len(self.tables[s]) for s in seq_ids), default=1)
        pt = np.full((len(seq_ids), max_pages), -1, np.int32)
        ln = np.zeros((len(seq_ids),), np.int32)
        for i, s in enumerate(seq_ids):
            pages = self.tables[s]
            pt[i, :len(pages)] = pages
            ln[i] = self.lengths[s]
        return (torch.from_numpy(pt).to(self.device),
                torch.from_numpy(ln).to(self.device))

    def write_token_kv(self, layer: int, seq_id: int, k, v) -> None:
        """Write one token's K/V (kvH, hd) into the page pool, in place
        (the JAX package rebuilds the pool array instead)."""
        pos = self.lengths[seq_id] - 1
        page = self.tables[seq_id][pos // self.pc.page_size]
        slot = pos % self.pc.page_size
        self.pool[layer, 0, page, slot] = k      # cast rounds to nearest even
        self.pool[layer, 1, page, slot] = v

    def attend(self, layer: int, seq_ids: List[int], q) -> torch.Tensor:
        """Decode attention for the given sequences via the paged kernel.
        q: (B, H, hd) → (B, H, hd)."""
        pt, ln = self.page_table_array(seq_ids)
        return ops.decode_attention(
            q, self.pool[layer, 0], self.pool[layer, 1], pt, ln)

    # -- GC: run-coalesced compaction (paper III-B.4 on device pages) -------
    def compact(self) -> int:
        """Pack live pages to the front of the pool.

        Hot/cold placement (paper III-B.3): ACTIVE sequences' pages are
        packed before FROZEN ones, so the hot region stays dense and the
        next compaction touches mostly-cold long-lived pages.
        Returns the number of copy DMAs issued (coalescing metric)."""
        valid = np.zeros(self.pc.n_pages, bool)
        for s, pages in self.tables.items():
            for p in pages:
                valid[p] = True
        n_live = int(valid.sum())
        # One plan moves every (layer, k/v) plane.  The live pages are
        # gathered out of place (a tail page can land above its old slot,
        # so an in-place gather would overwrite sources not yet read), then
        # written back over the front of the pool.  Slots at and past n_live
        # keep their old pages, as the JAX package's identity permutation
        # leaves them: attend reads prompt slots that add_sequence reserved
        # but nothing wrote.
        planes = self.pool.view(self.cfg.n_layers * 2, self.pc.n_pages,
                                self.pc.page_size, -1)
        live = planes.new_empty((planes.shape[0], n_live) + planes.shape[2:])
        _, new_index, dmas = ops.compact_pages(
            planes, valid, block_pages=self.pc.compact_block_pages, out=live)
        planes[:, :n_live] = live
        total_dmas = dmas * self.cfg.n_layers * 2
        # rewrite tables + free list
        for s in self.tables:
            self.tables[s] = [int(new_index[p]) for p in self.tables[s]]
        self.free = list(range(self.pc.n_pages - 1, n_live - 1, -1))
        self.compactions += 1
        self.compaction_dmas += total_dmas
        return total_dmas
