"""Adaptive KV placement: size/lifetime-aware separate-vs-inline policy.

Scavenger+ (like every KV-separated system it evaluates) draws the
separate-vs-inline boundary at a fixed value size (512 B, Section IV-A),
yet the paper's own space decomposition shows the two space-amplification
sources — blob garbage vs index-tree bloat — depend entirely on *which*
values get separated.  Hybrid-placement work (Xanthakis et al.) shows the
optimal boundary is workload-dependent; DumpKV shows update *lifetime* is
the second axis: a value that will be overwritten soon becomes blob
garbage almost immediately and is cheaper to keep inline, where the next
compaction reclaims it for free.

This module makes the boundary a per-store, per-workload variable:

* :class:`HeatSketch` — the DropCache of paper III-B.3 generalized from a
  membership LRU into a *drop-count* sketch: how many times was this key
  recently overwritten?  One sketch serves both consumers: the hot/cold
  vSST output splitting (membership, as before) and the placement policy
  (counts, as a per-key lifetime signal).
* :class:`SizeHistogram` — decayed log2-bucketed population of value
  sizes, kept twice: sizes *written* and sizes *overwritten* (churn).
  Their per-bucket ratio estimates the update rate of each size class.
* :class:`PlacementEngine` — combines the histograms with measured
  amplification signals (index-tree write amp from flush/compaction
  bytes, GC rewrite amp from GC output/reclaim bytes, the live
  ``S_index``) into a cost model, and periodically re-picks the
  *effective threshold* minimizing modeled space + write cost.  Records
  then *migrate lazily on rewrite*: GC reattaches small/cold separated
  values inline during its rewrite pass, and compaction re-separates
  large inline values when the threshold has dropped — no dedicated
  rewrite jobs, the migrations ride the machinery that was rewriting the
  record anyway (exactly how slot migrations ride GC in rebalance.py).

Cost model (per record of size ``s`` in a bucket with churn ratio ``u``):

========  =====================================  =========================
 choice    write bytes                            space overhead bytes
========  =====================================  =========================
 inline    ``(s + K) * W``                        ``(s + K) * tree_over``
 separate  ``(E + K) * W``  (the index entry)     ``(E + K) * tree_over``
           ``+ (s + K + H) * (1 + u * G)``        ``+ (K + H)`` (key copy +
                                                  per-record vSST index)
                                                  ``+ s * min(u,2) * (B+R_G)``
========  =====================================  =========================

with ``K`` the average key size, ``E`` the index-entry payload size,
``H`` the value-store per-record overhead (length framing + dense-index
slot), ``W`` the measured index-tree write amplification (each inline
byte is rewritten by every compaction it participates in), ``G`` the
measured GC rewrite amplification (live bytes rewritten per garbage byte
reclaimed; prior ``(1-R_G)/R_G``), ``tree_over`` the measured
``S_index - 1`` and ``B = R_G/(1-R_G)`` the steady-state *exposed* blob
garbage residency per live separated byte.  The extra ``R_G`` in the
residency term stands in for *hidden* garbage — an overwritten separated
value stays in the engine's live accounting until compaction drops its
shadowed index entry (the paper's Fig. 6 decomposition), so churned
bytes linger beyond what the exposed ratio admits.  The ``u * G`` term
is DumpKV's lifetime argument: every overwrite of a separated value
strands its bytes in blob space until GC rewrites the victim's live
neighbours.  ``Options.placement_space_weight`` trades the two columns —
its default leans toward space, matching the paper's evaluation under a
1.5x space cap (Fig. 13) — and the effective threshold is the bucket
boundary minimizing the population total, EWMA-smoothed against thrash.

The **read-cost term** (per measured point read of the bucket): a
separated value pays one extra device hop per read unless the shared
read cache (:mod:`.cache`) absorbs it.  Per record it adds
``read_weight * reads_per_record * (1 - absorb_ratio) * (s + H +
READ_HOP_BYTES)`` to the separate column, with the read rate and the
absorb ratio both *measured* — the cache exports per-size-class
read-heat counters which the engine drains at each retune.  Hot-read
small values therefore stay inline (no second hop), and read traffic
the cache absorbs never argues against separation.
``Options.placement_read_weight`` scales the term; 0 disables it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict


class HeatSketch:
    """LRU of recently-overwritten keys with drop counts (paper III-B.3
    generalized).  ``is_hot`` preserves the original DropCache membership
    contract (and its hit/query counters); ``drop_count`` is the
    placement engine's lifetime signal — a key overwritten ``d`` times
    recently is expected to be overwritten again soon."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._keys: "OrderedDict[bytes, int]" = OrderedDict()
        self.inserts = 0
        self.hits = 0
        self.queries = 0

    def record_drop(self, ukey: bytes) -> None:
        self.inserts += 1
        cnt = self._keys.pop(ukey, 0)
        self._keys[ukey] = cnt + 1
        if len(self._keys) > self.capacity:
            self._keys.popitem(last=False)

    def is_hot(self, ukey: bytes) -> bool:
        self.queries += 1
        if ukey in self._keys:
            self.hits += 1
            return True
        return False

    def drop_count(self, ukey: bytes) -> int:
        """Recent overwrite count; no hit/query accounting (internal
        placement probes must not skew the hot/cold split's hit rate)."""
        return self._keys.get(ukey, 0)

    def __len__(self) -> int:
        return len(self._keys)


# Log2 bucket layout: bucket i covers sizes (2^(i+MIN_LOG2-1), 2^(i+MIN_LOG2)].
MIN_LOG2 = 4                    # first bucket tops out at 16 B
MAX_LOG2 = 18                   # last bucket: everything above 128 KB
N_BUCKETS = MAX_LOG2 - MIN_LOG2 + 1


def bucket_of(size: int) -> int:
    return min(max((max(size, 1) - 1).bit_length() - MIN_LOG2, 0),
               N_BUCKETS - 1)


def bucket_boundary(i: int) -> int:
    """Smallest size routed to bucket ``i`` (a candidate threshold)."""
    return 1 if i == 0 else (1 << (i + MIN_LOG2 - 1)) + 1


class SizeHistogram:
    """Decayed log2 histogram of value sizes: per-bucket record counts and
    byte totals.  Decay keeps the view recent (a workload shift re-tunes
    the threshold within a few windows) without per-record timestamps."""

    def __init__(self) -> None:
        self.counts = [0.0] * N_BUCKETS
        self.bytes = [0.0] * N_BUCKETS

    def add(self, size: int) -> None:
        b = bucket_of(size)
        self.counts[b] += 1.0
        self.bytes[b] += size

    def decay(self, factor: float = 0.5) -> None:
        for i in range(N_BUCKETS):
            self.counts[i] *= factor
            self.bytes[i] *= factor

    @property
    def total(self) -> float:
        return sum(self.counts)


INDEX_ENTRY_BYTES = 12          # KF/KA payload: varint fid + size/offset
VSST_RECORD_HEADER = 24         # length framing + dense-index slot
# Byte-equivalent of the extra device *op* a separated point read pays
# (the second hop into the value store): one block, the unit the rest of
# the cost model already thinks in.  The real 80 us latency would
# convert to ~256 KB at device bandwidth and drown every other term;
# one block keeps the read hop comparable to the write/space columns
# while still making frequently-read small values expensive to separate.
READ_HOP_BYTES = 4096


class PlacementEngine:
    """Per-store separate-vs-inline policy.

    With ``opts.adaptive_placement`` off the engine is a transparent
    stand-in for the legacy ``size >= sep_threshold`` test (plus record
    counters); on, it observes the write stream, re-tunes
    ``self.threshold`` from the cost model every
    ``opts.placement_retune_interval`` observations, scales the
    per-record boundary by the key's recent drop count (hot keys stay
    inline longer — their separated bytes would die fastest), and
    arbitrates the lazy migrations:

    * :meth:`want_inline_on_gc` — GC is rewriting a live separated
      record anyway; reattach it inline if it is clearly below the
      boundary (hysteresis guards against inline<->separated ping-pong
      when the threshold wiggles).
    * :meth:`want_separate_on_compaction` — compaction is rewriting an
      inline record anyway; separate it if it is clearly above.
    """

    def __init__(self, opts) -> None:
        self.opts = opts
        self.heat = HeatSketch(opts.dropcache_entries)
        self.sizes = SizeHistogram()        # sizes written
        self.churn = SizeHistogram()        # sizes overwritten (dropped)
        self.reads = SizeHistogram()        # sizes point-read (user)
        self.absorbed = SizeHistogram()     # ... whose hop the cache served
        # Read-heat provider: the store's shared-cache handle (set by
        # KVStore).  Drained at each retune so the cost model sees the
        # measured per-size-class point-read rate and how much of it the
        # block cache absorbs — the read-cost term's two inputs.
        self.read_heat_source = None
        # Block-subsystem counters (the device's BlockCodecStats, set by
        # KVStore): measured compression ratios re-scale the space terms —
        # a compressed-inline byte occupies less tree than a raw one — and
        # the vSST wasted-probe rate prices negative-lookup hops, which
        # per-table filters drive to ~0.
        self.blockio_source = None
        # Observability hook (set by KVStore): called with the new
        # effective threshold after each completed retune, so an active
        # TraceRecorder can mark the decision as an instant event.
        self.on_retune = None
        self.threshold = opts.sep_threshold
        self.counters: Dict[str, int] = {
            "inline_records": 0, "separated_records": 0,
            "migr_to_inline_keys": 0, "migr_to_inline_bytes": 0,
            "migr_to_sep_keys": 0, "migr_to_sep_bytes": 0,
            "retunes": 0,
        }
        # measured amplification signals (fed by db/compaction/gc)
        self._flush_index_bytes = 0
        self._compaction_bytes = 0
        self._gc_rewritten_bytes = 0
        self._gc_collected_bytes = 0
        self._s_index = 1.11                # prior: 1 + sum 1/T^i at T=10
        self._key_bytes_avg = 24.0
        self._ticks = 0

    # -- observation hooks (write path / compaction / GC) -----------------
    def observe_write(self, ukey: bytes, size: int) -> None:
        """A user value write entered the memtable."""
        self.sizes.add(size)
        self._key_bytes_avg += 0.01 * (len(ukey) - self._key_bytes_avg)
        self._tick()

    def observe_drop(self, ukey: bytes, old_bytes: int) -> None:
        """A live version of ``ukey`` was shadowed (memtable overwrite or
        compaction entry drop) — the lifetime signal.  Feeds both the
        hot/cold sketch and the churn histogram."""
        self.heat.record_drop(ukey)
        if self.opts.adaptive_placement and old_bytes > 0:
            self.churn.add(old_bytes)
            self._tick()

    def note_flush(self, index_bytes: int) -> None:
        self._flush_index_bytes += index_bytes

    def note_compaction(self, nbytes: int) -> None:
        self._compaction_bytes += nbytes

    def note_gc(self, rewritten: int, collected: int) -> None:
        self._gc_rewritten_bytes += rewritten
        self._gc_collected_bytes += max(0, collected)

    def note_tree(self, s_index: float) -> None:
        if s_index > 0:
            self._s_index = s_index

    # -- measured amplification -------------------------------------------
    def index_write_amp(self) -> float:
        """Bytes written into the index tree per byte flushed — how many
        times an inline byte is rewritten on its way down the levels.
        Clamped to sane LSM territory while the sample is thin."""
        if self._flush_index_bytes < 4096:
            return 3.0
        w = 1.0 + self._compaction_bytes / self._flush_index_bytes
        return min(max(w, 1.0), 12.0)

    def gc_rewrite_amp(self) -> float:
        """Live bytes GC rewrites per garbage byte it reclaims.  Prior
        before the first collections: ``(1 - R_G) / R_G`` for a plain
        greedy collector, but ~1.0 when DropCache hot/cold splitting is
        on — concentrating churn makes victims mostly-dead (paper
        III-B.3), and an overly pessimistic prior would park the
        boundary above the large buckets before GC ever gets a sample."""
        rg = self.opts.garbage_ratio
        if self._gc_collected_bytes < 4096:
            return 1.0 if self.opts.dropcache \
                else (1.0 - rg) / max(rg, 0.05)
        g = self._gc_rewritten_bytes / self._gc_collected_bytes
        return min(max(g, 0.0), 20.0)

    # -- decisions ---------------------------------------------------------
    def _key_threshold(self, ukey: bytes) -> int:
        """Per-record boundary: the effective threshold, doubled once per
        recent drop (capped) — a hot key's next version dies soon, so its
        value must be this much larger before separating pays."""
        thr = self.threshold
        if not self.opts.adaptive_placement:
            return thr
        d = self.heat.drop_count(ukey)
        if d:
            thr <<= min(d, self.opts.placement_heat_boost)
        return min(thr, self.opts.placement_max_threshold)

    def decide(self, ukey: bytes, size: int) -> bool:
        """Flush-time placement: True = separate into the value store."""
        if not self.opts.adaptive_placement:
            sep = size >= self.opts.sep_threshold
        else:
            sep = size >= self._key_threshold(ukey)
        if sep:
            self.counters["separated_records"] += 1
        else:
            self.counters["inline_records"] += 1
        return sep

    def want_inline_on_gc(self, ukey: bytes, size: int) -> bool:
        """GC rewrite pass: reattach this separated value inline?  Only
        when clearly below the boundary (hysteresis)."""
        if not self.opts.adaptive_placement:
            return False
        return size * self.opts.placement_hysteresis < \
            self._key_threshold(ukey)

    def want_separate_on_compaction(self, ukey: bytes, size: int) -> bool:
        """Compaction rewrite pass: re-separate this inline value?  Only
        when clearly above the boundary (hysteresis)."""
        if not self.opts.adaptive_placement or not self.opts.kv_separation:
            return False
        return size >= self._key_threshold(ukey) * \
            self.opts.placement_hysteresis

    def note_migration(self, to_separated: bool, nbytes: int) -> None:
        if to_separated:
            self.counters["migr_to_sep_keys"] += 1
            self.counters["migr_to_sep_bytes"] += nbytes
        else:
            self.counters["migr_to_inline_keys"] += 1
            self.counters["migr_to_inline_bytes"] += nbytes

    # -- retuning ----------------------------------------------------------
    def _tick(self) -> None:
        self._ticks += 1
        if self._ticks >= self.opts.placement_retune_interval:
            self._ticks = 0
            self.retune()

    def _pull_read_heat(self) -> None:
        """Fold the cache's window read-heat counters into the decayed
        read histograms (the cache counts, we own the decay cadence)."""
        src = self.read_heat_source
        if src is None:
            return
        r, a = src.drain_read_heat()
        for b in range(N_BUCKETS):
            self.reads.counts[b] += r[b]
            self.absorbed.counts[b] += a[b]

    def retune(self) -> None:
        """Re-pick the effective threshold from the cost model (see module
        docstring) over the decayed histograms, then decay them so the
        next window reflects the current workload."""
        if self.sizes.total < 32:       # not enough signal yet
            return
        self.counters["retunes"] += 1
        self._pull_read_heat()
        opts = self.opts
        w_amp = self.index_write_amp()
        g_amp = self.gc_rewrite_amp()
        key_b = self._key_bytes_avg
        entry = INDEX_ENTRY_BYTES
        hdr = VSST_RECORD_HEADER
        tree_over = min(max(self._s_index - 1.0, 0.02), 1.0)
        rg = opts.garbage_ratio
        blob_res = rg / (1.0 - rg)
        sw = opts.placement_space_weight
        rw = opts.placement_read_weight
        # Physical-encoding terms from the block subsystem: measured
        # stored/raw ratios shrink the *resident* byte terms (compression
        # attacks S_index bloat from the physical side), and the measured
        # wasted-probe rate prices the extra hops negative vSST lookups
        # cost — per-table filters collapse it toward zero.
        bio = self.blockio_source
        tree_comp = val_comp = 1.0
        wasted = 0.0
        if bio is not None:
            tree_comp = min(max(bio.ratio("tree"), 0.2), 1.0)
            val_comp = min(max(bio.ratio("value"), 0.2), 1.0)
            wasted = bio.wasted_probe_rate()

        inline_cost = [0.0] * N_BUCKETS
        sep_cost = [0.0] * N_BUCKETS
        for b in range(N_BUCKETS):
            n = self.sizes.counts[b]
            if n <= 0:
                continue
            s = self.sizes.bytes[b] / n
            u = min(self.churn.counts[b] / n, 2.0)
            inline_cost[b] = n * ((s + key_b) * w_amp
                                  + sw * (s + key_b) * tree_over * tree_comp)
            sep_cost[b] = n * ((entry + key_b) * w_amp
                               + (s + key_b + hdr) * (1.0 + u * g_amp)
                               + sw * ((entry + key_b) * tree_over * tree_comp
                                       + key_b + hdr
                                       + s * val_comp * min(u, 2.0)
                                       * (blob_res + rg)))
            # Read-cost term: every measured point read of this size
            # class that the cache did NOT absorb pays a second device
            # hop when the value is separated — an inline value rides
            # the index-block read that happened anyway.  Hot-read small
            # values therefore stay inline; cache-absorbed read traffic
            # costs separation nothing.
            if rw > 0 and self.reads.counts[b] > 0:
                miss = max(0.0, 1.0 - (self.absorbed.counts[b]
                                       / self.reads.counts[b]))
                reads_per_rec = self.reads.counts[b] / n
                sep_cost[b] += n * rw * reads_per_rec * miss \
                    * (s + hdr + READ_HOP_BYTES * (1.0 + wasted))

        # cost(t_i) = inline everything below bucket i, separate the rest;
        # one suffix-sum pass evaluates every boundary.
        suffix_sep = [0.0] * (N_BUCKETS + 1)
        for b in range(N_BUCKETS - 1, -1, -1):
            suffix_sep[b] = suffix_sep[b + 1] + sep_cost[b]
        best_i, best_cost, prefix_inline = 0, suffix_sep[0], 0.0
        for i in range(1, N_BUCKETS + 1):
            prefix_inline += inline_cost[i - 1]
            cost = prefix_inline + suffix_sep[i]
            if cost < best_cost:
                best_cost, best_i = cost, i
        raw = (opts.placement_max_threshold if best_i == N_BUCKETS
               else bucket_boundary(best_i))
        raw = min(max(raw, opts.placement_min_threshold),
                  opts.placement_max_threshold)
        # EWMA: half-way to the new optimum per window, so one noisy
        # window cannot swing the boundary across the whole ladder.
        self.threshold = max(1, int(round(0.5 * self.threshold + 0.5 * raw)))
        self.sizes.decay()
        self.churn.decay()
        self.reads.decay()
        self.absorbed.decay()
        if self.on_retune is not None:
            self.on_retune(self.threshold)

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "adaptive": bool(self.opts.adaptive_placement),
            "effective_threshold": self.threshold,
            "index_write_amp": round(self.index_write_amp(), 3),
            "gc_rewrite_amp": round(self.gc_rewrite_amp(), 3),
            "sizes_observed": int(self.sizes.total),
            "churn_observed": int(self.churn.total),
            "reads_observed": int(self.reads.total),
            "reads_absorbed": int(self.absorbed.total),
            "read_weight": self.opts.placement_read_weight,
            "tree_compression": (round(self.blockio_source.ratio("tree"), 4)
                                 if self.blockio_source is not None else 1.0),
            "value_compression": (round(self.blockio_source.ratio("value"), 4)
                                  if self.blockio_source is not None else 1.0),
            "wasted_probe_rate": (
                round(self.blockio_source.wasted_probe_rate(), 4)
                if self.blockio_source is not None else 0.0),
            **self.counters,
        }
