"""Continuous-batching request scheduler with the paper's dynamic
resource split (Section III-D reinterpreted for the serve loop).

Two pressures steer each engine iteration:

  P_admit  (≙ P_index)  — queued requests that cannot be admitted for
                          lack of contiguous free pages;
  P_frag   (≙ P_value)  — pool fragmentation (exposed-garbage analog).

When ``P_frag/(P_frag+P_admit)`` crosses the configured share, the loop
spends an iteration on page compaction instead of decode — exactly eq. 6
with "threads" replaced by step budget.  A rate cap (paper III-D.2)
bounds compaction frequency so decode latency is not starved.

Pure host logic, the same as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

from ..models.config import ModelConfig
from .kvcache import PagedKVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    frag_threshold: float = 0.25
    min_decode_between_compactions: int = 4


class ServeLoop:
    def __init__(self, cfg: ModelConfig, cache: PagedKVCache,
                 sc: Optional[ServeConfig] = None) -> None:
        self.cfg = cfg
        self.cache = cache
        self.sc = sc or ServeConfig()
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.done: List[int] = []
        self.decode_steps = 0
        self.compaction_steps = 0
        self._since_compaction = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # -- pressures (paper eqs. 4-6 analog) -------------------------------
    def pressures(self) -> Dict[str, float]:
        blocked = 0
        for r in list(self.queue)[:4]:
            need = -(-r.prompt_len // self.cache.pc.page_size)
            if need > self.cache.free_pages:
                blocked += 1
        p_admit = blocked / 4.0
        p_frag = self.cache.fragmentation()
        return {"admit": p_admit, "frag": p_frag}

    def should_compact(self) -> bool:
        if self._since_compaction < self.sc.min_decode_between_compactions:
            return False
        p = self.pressures()
        if p["frag"] <= self.sc.frag_threshold:
            return False
        denom = p["frag"] + p["admit"] + 1e-9
        return p["frag"] / denom >= 0.5

    # -- engine iteration --------------------------------------------------
    def admit(self) -> int:
        n = 0
        while self.queue and len(self.active) < self.sc.max_batch:
            r = self.queue[0]
            if not self.cache.add_sequence(r.rid, r.prompt_len):
                break
            self.queue.popleft()
            self.active[r.rid] = r
            n += 1
        return n

    def step(self, decode_fn) -> Dict[str, float]:
        """One engine iteration: maybe compact, admit, decode one token
        for every active sequence via ``decode_fn(seq_ids)``."""
        if self.should_compact():
            self.cache.compact()
            self.compaction_steps += 1
            self._since_compaction = 0
            return {"kind": 1.0}
        self.admit()
        seq_ids = list(self.active.keys())
        if seq_ids:
            ok_ids = [s for s in seq_ids if self.cache.append_token(s)]
            if ok_ids:
                decode_fn(ok_ids)
            finished = []
            for s in ok_ids:
                r = self.active[s]
                r.generated += 1
                if r.generated >= r.max_new_tokens:
                    finished.append(s)
            for s in finished:
                self.cache.finish_sequence(s)
                self.done.append(s)
                del self.active[s]
        self.decode_steps += 1
        self._since_compaction += 1
        return {"kind": 0.0}

    def run(self, decode_fn, max_steps: int = 10000) -> None:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step(decode_fn)
            steps += 1
