"""Unified shared read cache: one device-wide budget, per-shard admission.

Scavenger+ evaluates against a *single* device-wide block cache (Section
IV-A, 1 GB ≈ 1 % of the dataset) — DRAM is part of the same
cost-sensitive space budget the paper optimizes on flash.  The sharded
front-end used to slice that budget statically across shards, so a
read-hot tenant thrashed its slice while cold tenants' slices idled.
This module replaces the split with one :class:`SharedReadCache`:

* **segmented LRU** per shard — the high-priority protected region that
  keeps DTable index-entry blocks resident across GC-Lookups (paper
  III-B.2) is preserved per shard, low-priority insertions never evict
  it;
* a **ghost cache** per shard — fingerprints + sizes of recently evicted
  (or admission-bypassed) blocks.  A miss that hits the ghost is a
  device read that *slightly more capacity would have avoided*: the
  marginal-utility signal, and the frequency signal for admission
  (a block touched once by a scan never ghost-hits, so it cannot
  displace a tenant's re-read working set);
* **online quota re-tuning** — each shard owns a byte quota; quotas sum
  *exactly* to the device-wide budget at all times.  Every
  ``retune_interval`` lookups the quotas move toward the shards whose
  ghost hits say "one more MB would have saved N device reads", clamped
  by floor/ceiling knobs, EWMA-smoothed, and over-quota shards are
  evicted down immediately so total resident bytes never exceed the
  budget;
* a **fid → resident-keys index** so dropping a table evicts in time
  proportional to the file's resident blocks, not the whole cache;
* per-size-class **read-heat counters** (value point-reads, and how many
  were absorbed by the cache) drained by the
  :class:`~.placement.PlacementEngine` — the read-cost term of the
  placement model: a hot-read small value kept inline pays no second
  device hop, and a separated value whose blocks the cache absorbs
  doesn't either.

Shards attach through :class:`ShardCacheHandle`, which carries the full
legacy ``BlockCache`` surface (``get`` / ``put`` / ``evict_key`` /
``evict_file`` / ``hits`` / ``misses`` / ``hit_ratio``) so table readers
are oblivious to the sharing.  With ``adaptive=False`` the core degrades
to the static split: even quotas, no ghost, plain per-shard segmented
LRU — byte-for-byte the old per-shard ``BlockCache`` behaviour, which is
what the ``S-CACHE`` ablation compares against.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .placement import N_BUCKETS, bucket_of

CacheKey = Tuple[int, int]          # (fid, offset)

#: resident entries are (value, charge): the cache holds *decoded* blocks
#: but charges the *stored* (compressed) size against the byte budget —
#: DRAM spent mirrors device bytes saved, the same space axis the quota
#: retune already optimizes.
CacheEnt = Tuple[bytes, int]

#: Cap on per-shard pending re-admission marks (ghost-hit keys awaiting
#: their fill `put`); a mark is consumed by the very next fill in the
#: common path, the cap only bounds pathological get-without-put streams.
_READMIT_CAP = 512


class SharedReadCache:
    """Device-wide block cache shared by ``n_shards`` tenants."""

    #: Causal tracer hook (set by the owning store): misses land on the
    #: current sampled op's chain, so an exemplar can show the
    #: miss -> device-hop sequence behind a slow read.
    causal = None

    def __init__(self, capacity_bytes: int, n_shards: int = 1,
                 high_ratio: float = 0.5, adaptive: bool = False,
                 ghost_ratio: float = 1.0, quota_floor: float = 0.05,
                 quota_ceiling: float = 0.90,
                 retune_interval: int = 2048) -> None:
        assert n_shards >= 1
        # Leaf mutex (level 3 in the hierarchy, see core.concurrency):
        # shards on different threads share every structure below.
        # Reentrant because ``get`` re-tunes quotas on its own cadence.
        self._mu = threading.RLock()
        self.capacity = capacity_bytes
        self.n_shards = n_shards
        self.high_ratio = high_ratio
        self.adaptive = adaptive
        self.ghost_ratio = ghost_ratio
        self.quota_floor = quota_floor
        self.quota_ceiling = quota_ceiling
        self.retune_interval = max(1, retune_interval)
        # Initial quotas: even split, remainder to shard 0 — sums exactly
        # to the budget (the invariant every retune preserves).
        base, rem = divmod(capacity_bytes, n_shards)
        self.quotas: List[int] = [base + rem] + [base] * (n_shards - 1)
        n = n_shards
        self._low: List["OrderedDict[CacheKey, CacheEnt]"] = \
            [OrderedDict() for _ in range(n)]
        self._high: List["OrderedDict[CacheKey, CacheEnt]"] = \
            [OrderedDict() for _ in range(n)]
        self._low_bytes = [0] * n
        self._high_bytes = [0] * n
        # scan-window depth per shard: while >0, lookups neither promote
        # nor touch the ghost, and fills are bypassed entirely — one long
        # merged scan cannot evict the working set or pollute the ghost
        # with single-touch fingerprints.
        self._scan_depth = [0] * n
        self.scan_bypass = [0] * n
        self._ghost: List["OrderedDict[CacheKey, int]"] = \
            [OrderedDict() for _ in range(n)]
        self._ghost_bytes = [0] * n
        self._readmit: List[Set[CacheKey]] = [set() for _ in range(n)]
        self._fid_keys: Dict[int, Set[Tuple[int, CacheKey]]] = {}
        self._ghost_fids: Dict[int, Set[Tuple[int, CacheKey]]] = {}
        # cumulative counters (stats) and window counters (retune signal)
        self.hits = [0] * n
        self.misses = [0] * n
        self.ghost_hits = [0] * n
        self._w_hits = [0.0] * n
        self._w_ghost = [0.0] * n
        self._lookups_since_retune = 0
        self.quota_retunes = 0
        # Observability hook (set by the owning store): called with the
        # new per-shard quotas after each completed adaptive retune.
        self.on_retune = None
        # per-shard, per-size-class read heat: value point-reads and the
        # subset whose second hop the cache absorbed.  Cumulative pair for
        # stats, window pair drained by the placement engine.
        self._reads = [[0] * N_BUCKETS for _ in range(n)]
        self._absorbed = [[0] * N_BUCKETS for _ in range(n)]
        self._w_reads = [[0] * N_BUCKETS for _ in range(n)]
        self._w_absorbed = [[0] * N_BUCKETS for _ in range(n)]

    @classmethod
    def from_options(cls, opts, n_shards: int = 1) -> "SharedReadCache":
        return cls(opts.cache_bytes, n_shards=n_shards,
                   adaptive=opts.shared_cache,
                   ghost_ratio=opts.cache_ghost_ratio,
                   quota_floor=opts.cache_quota_floor,
                   quota_ceiling=opts.cache_quota_ceiling,
                   retune_interval=opts.cache_retune_interval)

    def handle(self, sid: int) -> "ShardCacheHandle":
        assert 0 <= sid < self.n_shards
        return ShardCacheHandle(self, sid)

    # ==================================================================
    # Lookup / insert
    # ==================================================================

    def get(self, sid: int, key: CacheKey) -> Optional[bytes]:
        with self._mu:
            # Re-tune on a lookup cadence, hits included — a long hit-only
            # stretch must still decay the window counters, or stale hit
            # history from it would dominate quota decisions long after the
            # shard went idle.
            self._lookups_since_retune += 1
            if self.adaptive and self._lookups_since_retune >= \
                    self.retune_interval:
                self.retune_quotas()
            scanning = self._scan_depth[sid] > 0
            for q in (self._high[sid], self._low[sid]):
                v = q.get(key)
                if v is not None:
                    # Scan hits count, but don't refresh recency — a scan
                    # touching a block once says nothing about reuse.
                    if not scanning:
                        q.move_to_end(key)
                    self.hits[sid] += 1
                    self._w_hits[sid] += 1
                    return v[0]
            self.misses[sid] += 1
            if self.causal is not None:
                self.causal.note_cache_miss(sid)
            if self.adaptive and not scanning:
                sz = self._ghost[sid].pop(key, None)
                if sz is not None:
                    # A ghost hit: the device read about to happen is one a
                    # larger quota would have served from DRAM.
                    self._ghost_bytes[sid] -= sz
                    self._drop_ghost_fid(sid, key)
                    self.ghost_hits[sid] += 1
                    self._w_ghost[sid] += 1
                    if len(self._readmit[sid]) < _READMIT_CAP:
                        self._readmit[sid].add(key)
            return None

    def put(self, sid: int, key: CacheKey, value: bytes,
            high_priority: bool = False,
            charge: Optional[int] = None) -> None:
        """Insert a block; ``charge`` (default ``len(value)``) is the byte
        cost counted against the quota — the stored/compressed size when
        the resident bytes are a decoded block."""
        with self._mu:
            if self._scan_depth[sid] > 0:
                # Scan-window fill: skip both residency and the ghost.
                self.scan_bypass[sid] += 1
                return
            size = len(value) if charge is None else charge
            quota = self.quotas[sid]
            readmit = key in self._readmit[sid]
            if readmit:
                self._readmit[sid].discard(key)
            if size > quota:
                # Over-size for this shard's current slice.  Still leave a
                # fingerprint (fair-share-sized ghost, see _ghost_put): an
                # idle shard shrunk to the floor must be able to prove
                # demand and grow back — re-reads of bypassed blocks are
                # ghost hits.
                if self.adaptive:
                    self._ghost_put(sid, key, size)
                return
            self.evict_key(sid, key)
            if self.adaptive and not high_priority and not readmit:
                resident = self._low_bytes[sid] + self._high_bytes[sid]
                if resident + size > quota:
                    # Admission under pressure is frequency-gated: a block
                    # never seen before (no ghost hit) does not displace
                    # the shard's resident set — it leaves a fingerprint
                    # instead, and its next read within the ghost window
                    # admits it.  This is what makes one tenant's long
                    # scan unable to wash out even its *own* hot set, let
                    # alone a neighbour's (theirs is quota-protected
                    # anyway).
                    self._ghost_put(sid, key, size)
                    return
            if high_priority:
                self._high[sid][key] = (value, size)
                self._high_bytes[sid] += size
            else:
                self._low[sid][key] = (value, size)
                self._low_bytes[sid] += size
            self._fid_keys.setdefault(key[0], set()).add((sid, key))
            self._enforce_quota(sid)

    def _enforce_quota(self, sid: int) -> None:
        """Evict (→ ghost) until shard ``sid`` fits its quota: the high
        region to its protected share, then the low region to whatever
        the high residents leave."""
        quota = self.quotas[sid]
        high_cap = int(quota * self.high_ratio)
        high = self._high[sid]
        while self._high_bytes[sid] > high_cap and high:
            k, (_, sz) = high.popitem(last=False)
            self._high_bytes[sid] -= sz
            self._drop_fid_key(sid, k)
            if self.adaptive:
                self._ghost_put(sid, k, sz)
        low_cap = quota - self._high_bytes[sid]
        low = self._low[sid]
        while self._low_bytes[sid] > low_cap and low:
            k, (_, sz) = low.popitem(last=False)
            self._low_bytes[sid] -= sz
            self._drop_fid_key(sid, k)
            if self.adaptive:
                self._ghost_put(sid, k, sz)

    # ==================================================================
    # Eviction
    # ==================================================================

    def evict_key(self, sid: int, key: CacheKey) -> None:
        with self._mu:
            v = self._low[sid].pop(key, None)
            if v is not None:
                self._low_bytes[sid] -= v[1]
                self._drop_fid_key(sid, key)
            v = self._high[sid].pop(key, None)
            if v is not None:
                self._high_bytes[sid] -= v[1]
                self._drop_fid_key(sid, key)

    def evict_file(self, sid: int, fid: int) -> None:
        """Drop every resident block — and every ghost fingerprint — of
        ``fid``, in O(the file's entries) via the fid indexes, not
        O(entire cache).  Fids are never reused, so a dropped file's
        fingerprints could never ghost-hit again; left behind they would
        only squat in the bounded ghost window and push out live
        fingerprints right after a compaction/GC wave."""
        with self._mu:
            for owner, key in self._fid_keys.pop(fid, ()):
                v = self._low[owner].pop(key, None)
                if v is not None:
                    self._low_bytes[owner] -= v[1]
                    continue
                v = self._high[owner].pop(key, None)
                if v is not None:
                    self._high_bytes[owner] -= v[1]
            for owner, key in self._ghost_fids.pop(fid, ()):
                sz = self._ghost[owner].pop(key, None)
                if sz is not None:
                    self._ghost_bytes[owner] -= sz
            # Pending re-admission marks are ghost-hit keys awaiting their
            # fill ``put``.  A dropped file's fill can never come (fids are
            # not reused), so stale marks would squat in the capped
            # (_READMIT_CAP) set and block marks for live blocks.
            for marks in self._readmit:
                stale = [k for k in marks if k[0] == fid]
                for k in stale:
                    marks.discard(k)

    def _drop_fid_key(self, sid: int, key: CacheKey) -> None:
        s = self._fid_keys.get(key[0])
        if s is not None:
            s.discard((sid, key))
            if not s:
                del self._fid_keys[key[0]]

    # ==================================================================
    # Scan windows
    # ==================================================================

    def begin_scan(self, sid: int) -> None:
        with self._mu:
            self._scan_depth[sid] += 1

    def end_scan(self, sid: int) -> None:
        with self._mu:
            self._scan_depth[sid] = max(0, self._scan_depth[sid] - 1)

    # ==================================================================
    # Ghost cache
    # ==================================================================

    def _ghost_cap(self) -> int:
        """Ghost capacity is sized off the *fair share*, not the live
        quota: a shard squeezed to the floor keeps a full-width demand
        signal, otherwise it could never prove it deserves to grow."""
        return int(self.ghost_ratio * self.capacity / self.n_shards)

    def _ghost_put(self, sid: int, key: CacheKey, size: int) -> None:
        g = self._ghost[sid]
        old = g.pop(key, None)
        if old is not None:
            self._ghost_bytes[sid] -= old
        g[key] = size
        self._ghost_bytes[sid] += size
        self._ghost_fids.setdefault(key[0], set()).add((sid, key))
        cap = self._ghost_cap()
        while self._ghost_bytes[sid] > cap and g:
            k, sz = g.popitem(last=False)
            self._ghost_bytes[sid] -= sz
            self._drop_ghost_fid(sid, k)

    def _drop_ghost_fid(self, sid: int, key: CacheKey) -> None:
        s = self._ghost_fids.get(key[0])
        if s is not None:
            s.discard((sid, key))
            if not s:
                del self._ghost_fids[key[0]]

    # ==================================================================
    # Quota re-tuning
    # ==================================================================

    def retune_quotas(self) -> None:
        """Move quota toward the shards whose ghosts report marginal
        utility.  Quotas stay clamped to [floor, ceiling] fractions of
        the budget and always sum exactly to it; shrunk shards are
        evicted down immediately so the aggregate-resident invariant
        survives the re-tune itself."""
        with self._mu:
            self._lookups_since_retune = 0
            n = self.n_shards
            if not self.adaptive or n <= 1:
                return
            # Utility: ghost hits are device reads a bigger slice would
            # have saved; live hits (damped) keep a currently-useful shard
            # from being raided the moment its ghost goes quiet.
            w = [self._w_ghost[s] + 0.125 * self._w_hits[s]
                 for s in range(n)]
            total_w = sum(w)
            # Window decay (not reset): two quiet windows forget a burst.
            for s in range(n):
                self._w_ghost[s] *= 0.5
                self._w_hits[s] *= 0.5
            if total_w <= 0:
                return
            self.quota_retunes += 1
            cap = self.capacity
            floor = min(int(self.quota_floor * cap), cap // n)
            ceiling = max(int(self.quota_ceiling * cap), -(-cap // n))
            free = cap - n * floor
            target = [floor + free * ws / total_w for ws in w]
            raw = [0.5 * self.quotas[s] + 0.5 * target[s]
                   for s in range(n)]
            self.quotas = self._normalize(raw, floor, ceiling, cap)
            assert sum(self.quotas) == cap, (self.quotas, cap)
            for s in range(n):
                self._enforce_quota(s)
            if self.on_retune is not None:
                self.on_retune(list(self.quotas))

    @staticmethod
    def _normalize(raw: List[float], lo: int, hi: int,
                   total: int) -> List[int]:
        """Round + clamp to [lo, hi] with an exact sum of ``total``."""
        q = [min(max(int(x), lo), hi) for x in raw]
        diff = total - sum(q)
        i = 0
        guard = 4 * len(q) + 8
        while diff != 0 and guard > 0:
            s = i % len(q)
            i += 1
            guard -= 1
            if diff > 0 and q[s] < hi:
                step = min(diff, hi - q[s])
                q[s] += step
                diff -= step
            elif diff < 0 and q[s] > lo:
                step = min(-diff, q[s] - lo)
                q[s] -= step
                diff += step
        if diff:                    # infeasible clamp band: relax on 0
            q[0] += diff
        return q

    # ==================================================================
    # Read heat (placement export)
    # ==================================================================

    def note_value_read(self, sid: int, size: int, absorbed: bool) -> None:
        """A user point-read resolved a value of ``size`` bytes;
        ``absorbed`` means the cache served the second hop (the value
        block of a separated record), so separation cost that read
        nothing."""
        with self._mu:
            b = bucket_of(size)
            self._reads[sid][b] += 1
            self._w_reads[sid][b] += 1
            if absorbed:
                self._absorbed[sid][b] += 1
                self._w_absorbed[sid][b] += 1

    def drain_read_heat(self, sid: int) -> Tuple[List[int], List[int]]:
        """Hand the window's per-size-class (reads, absorbed) counters to
        the caller (the shard's placement engine) and reset the window."""
        with self._mu:
            r, a = self._w_reads[sid], self._w_absorbed[sid]
            self._w_reads[sid] = [0] * N_BUCKETS
            self._w_absorbed[sid] = [0] * N_BUCKETS
            return r, a

    # ==================================================================
    # Accounting / stats
    # ==================================================================

    def resident_bytes(self, sid: Optional[int] = None) -> int:
        with self._mu:
            if sid is not None:
                return self._low_bytes[sid] + self._high_bytes[sid]
            return sum(self._low_bytes) + sum(self._high_bytes)

    def shard_stats(self, sid: int) -> Dict[str, object]:
        with self._mu:
            return self._shard_stats_locked(sid)

    def _shard_stats_locked(self, sid: int) -> Dict[str, object]:
        tot = self.hits[sid] + self.misses[sid]
        reads = sum(self._reads[sid])
        return {
            "quota_bytes": self.quotas[sid],
            "resident_bytes": self.resident_bytes(sid),
            "hits": self.hits[sid],
            "misses": self.misses[sid],
            "hit_ratio": self.hits[sid] / tot if tot else 0.0,
            "ghost_hits": self.ghost_hits[sid],
            "ghost_hit_ratio": (self.ghost_hits[sid] / self.misses[sid]
                                if self.misses[sid] else 0.0),
            "scan_bypass": self.scan_bypass[sid],
            "value_reads": reads,
            "value_reads_absorbed": sum(self._absorbed[sid]),
            # size-class (log2 bucket) → point reads of values that size
            "read_heat": {b: self._reads[sid][b]
                          for b in range(N_BUCKETS) if self._reads[sid][b]},
        }

    def stats(self) -> Dict[str, object]:
        with self._mu:
            hits, misses = sum(self.hits), sum(self.misses)
            tot = hits + misses
            return {
                "adaptive": self.adaptive,
                "capacity_bytes": self.capacity,
                "resident_bytes": (sum(self._low_bytes)
                                   + sum(self._high_bytes)),
                "quota_bytes": list(self.quotas),
                "quota_sum_bytes": sum(self.quotas),
                "quota_retunes": self.quota_retunes,
                "hits": hits,
                "misses": misses,
                "hit_ratio": hits / tot if tot else 0.0,
                "ghost_hits": sum(self.ghost_hits),
                "scan_bypass": sum(self.scan_bypass),
                "per_shard": [self._shard_stats_locked(s)
                              for s in range(self.n_shards)],
            }


class ShardCacheHandle:
    """One shard's view of a :class:`SharedReadCache` — the legacy
    ``BlockCache`` surface, plus the read-heat export the placement
    engine drains.  Table readers hold one of these and never see the
    sharing."""

    __slots__ = ("core", "sid")

    def __init__(self, core: SharedReadCache, sid: int) -> None:
        self.core = core
        self.sid = sid

    def get(self, key: CacheKey) -> Optional[bytes]:
        return self.core.get(self.sid, key)

    def put(self, key: CacheKey, value: bytes,
            high_priority: bool = False,
            charge: Optional[int] = None) -> None:
        self.core.put(self.sid, key, value, high_priority=high_priority,
                      charge=charge)

    @contextmanager
    def scan_window(self) -> Iterator[None]:
        """Tag the enclosed reads as one scan: cache hits still count but
        nothing is promoted, admitted, or ghost-fingerprinted."""
        self.core.begin_scan(self.sid)
        try:
            yield
        finally:
            self.core.end_scan(self.sid)

    def evict_key(self, key: CacheKey) -> None:
        self.core.evict_key(self.sid, key)

    def evict_file(self, fid: int) -> None:
        self.core.evict_file(self.sid, fid)

    def note_value_read(self, size: int, absorbed: bool) -> None:
        self.core.note_value_read(self.sid, size, absorbed)

    def drain_read_heat(self) -> Tuple[List[int], List[int]]:
        return self.core.drain_read_heat(self.sid)

    @property
    def capacity(self) -> int:
        """The shard's *current* byte allowance (its quota)."""
        return self.core.quotas[self.sid]

    @property
    def hits(self) -> int:
        return self.core.hits[self.sid]

    @property
    def misses(self) -> int:
        return self.core.misses[self.sid]

    @property
    def ghost_hits(self) -> int:
        return self.core.ghost_hits[self.sid]

    @property
    def hit_ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def stats(self) -> Dict[str, object]:
        return self.core.shard_stats(self.sid)
