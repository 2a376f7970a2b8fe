"""Engine configuration and the paper's system/ablation presets.

Sizes default to a 1/512 scale of the paper's testbed configuration
(Section IV-A: memtable 64 MB, kSST 64 MB, vSST 256 MB, block cache 1 GB ≈
1 % of the 100 GB dataset, separation threshold 512 B, T = 10, R_G = 0.2,
16 background threads) so ratios — and therefore amplification behaviour —
are preserved while runs stay laptop-sized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Options:
    # --- structure ----------------------------------------------------
    kv_separation: bool = True
    sep_threshold: int = 512          # values >= this go to the value store
    index_kind: str = "kf"            # 'ka' (WiscKey/Titan) | 'kf' (TerarkDB)
    vsst_format: str = "btable"       # 'log' | 'btable' | 'rtable'
    ksst_format: str = "btable"       # 'btable' | 'dtable'

    # --- sizes (1/512 of the paper's setup) ----------------------------
    memtable_bytes: int = 128 * 1024
    ksst_bytes: int = 128 * 1024
    vsst_bytes: int = 512 * 1024
    block_bytes: int = 4 * 1024
    cache_bytes: int = 2 * 1024 * 1024
    bits_per_key: int = 10
    num_levels: int = 7
    level_multiplier: int = 10        # T
    l0_trigger: int = 4
    l0_slowdown: int = 8
    l0_stop: int = 12
    level_base_bytes: int = 256 * 1024

    # --- GC -------------------------------------------------------------
    gc_mode: str = "standalone"       # 'standalone' | 'compaction' (BlobDB)
    garbage_ratio: float = 0.2        # R_G
    write_back_index: bool = False    # Titan-style Write-Index step
    blob_age_cutoff: float = 0.25     # BlobDB oldest-file fraction rewritten

    # Dynamic Capacity Adaptation (RocksDB dynamic leveling).  The paper
    # enables it for RocksDB (II-D.2); the KV-separated forks of that era
    # default to static level targets — which is exactly why their
    # shrunken index trees sit below the size triggers and accumulate
    # hidden garbage (Fig. 6/11).  Compensated-size compaction re-enables
    # logical-size-driven leveling (III-C).
    dca: bool = True

    # --- Scavenger+ features (Fig. 19/20 ablation switches) -------------
    compensated_size: bool = False    # TDB-C  (paper III-C)
    dropcache: bool = False           # W      (paper III-B.3)
    adaptive_readahead: bool = False  # S-A    (paper III-B.4)
    dynamic_scheduler: bool = False   # S-AD   (paper III-D)
    dropcache_entries: int = 4096

    # --- adaptive KV placement (core/placement.py) -----------------------
    # With adaptive_placement on, ``sep_threshold`` is only the *initial*
    # boundary: the PlacementEngine re-tunes an effective threshold from a
    # space-vs-write-amp cost model over the observed value-size and
    # update-rate (churn) histograms, and records migrate lazily on
    # rewrite — GC reattaches small/cold separated values inline,
    # compaction re-separates large inline values.  S-ADP ablation switch.
    adaptive_placement: bool = False
    # Clamp band for the effective threshold (bytes).
    placement_min_threshold: int = 64
    placement_max_threshold: int = 64 * 1024
    # Observations (value writes + observed overwrites) between cost-model
    # re-tunes; each retune also decays the histograms by half.
    placement_retune_interval: int = 1024
    # Weight of modeled space-overhead bytes against write-amp bytes in
    # the cost model.  A resident byte is worth several rewritten bytes
    # by default: the paper evaluates under a 1.5x space *cap* (Fig. 13),
    # where resident overhead converts directly into write stalls.
    placement_space_weight: float = 4.0
    # Migration hysteresis: GC reattaches inline only when size * h <
    # threshold, compaction re-separates only when size >= threshold * h —
    # a wiggling boundary must not ping-pong records between homes.
    placement_hysteresis: float = 2.0
    # Per-key heat boost: each recent drop of a key doubles its personal
    # threshold, up to this many doublings (DumpKV's lifetime rule: a
    # value about to be overwritten is cheapest kept inline).
    placement_heat_boost: int = 2
    # Weight of the read-cost term in the placement model: each measured
    # point read of a separated value that the cache does not absorb
    # costs an extra device hop (paper's lazy-read asymmetry, from the
    # *read* side).  0 disables the term (write/space model only).
    placement_read_weight: float = 1.0

    # --- shared read cache (core/cache.py) -------------------------------
    # With shared_cache on, the device-wide cache budget is managed as ONE
    # SharedReadCache: per-shard admission quotas re-tuned online from
    # ghost-cache marginal utility (a shard whose ghost hits say "one
    # more MB would have saved N device reads" grows, idle slices
    # shrink), frequency-gated admission under pressure, exact
    # aggregate-budget accounting.  Off = static even split (the legacy
    # behaviour, and the S-CACHE ablation baseline).
    shared_cache: bool = False
    # Ghost (evicted-fingerprint) capacity as a fraction of each shard's
    # fair share of the budget.
    cache_ghost_ratio: float = 1.0
    # Quota clamp band, as fractions of the device-wide budget.
    cache_quota_floor: float = 0.05
    cache_quota_ceiling: float = 0.90
    # Cache lookups between quota re-tunes.
    cache_retune_interval: int = 2048

    # --- block I/O: per-table filters + compressed checksummed blocks ----
    # Bits/key of the partitioned per-table Bloom filters (kSST sections
    # AND vSST key sets).  None inherits ``bits_per_key``; 0 disables
    # filter blocks entirely.
    bloom_bits_per_key: Optional[int] = None
    # Block codec: 'none' (checksummed raw) or 'lz4' (simulated-cost fast
    # compressor; per-size-class ratios from the value model).  All v2
    # blocks carry a CRC32 either way.
    block_compression: str = "none"
    # Store a block compressed only when stored/raw < this ratio —
    # incompressible blocks stay raw and skip the decompress CPU on read.
    compression_min_ratio: float = 0.9

    # --- sharded front-end: slot routing + online rebalancing ------------
    num_slots: int = 256              # fixed routing slots (keys hash here)
    rebalance: bool = False           # enable the online slot balancer
    rebalance_threshold: float = 1.5  # trigger when max load > thr * mean
    rebalance_min_bytes: int = 256 * 1024  # ignore divergence below this

    # --- scheduling ------------------------------------------------------
    n_threads: int = 8                # background lanes (paper: 16)
    flush_lanes: int = 2
    rate_limit_step: float = 0.2      # III-D.2: 20% throttle steps
    rate_window_s: float = 0.25

    # --- limits ----------------------------------------------------------
    space_cap_bytes: Optional[int] = None   # paper's "1.5x space limit"

    # --- observability (repro.obs) ---------------------------------------
    obs_sampling: bool = False        # latency histograms on foreground ops
    obs_sample_every: int = 64        # causal-trace 1-in-N op sampling rate
    obs_window_s: float = 0.5         # amplification-ledger window (sim s)
    obs_series_len: int = 256         # ledger ring-buffer length

    def validate(self) -> "Options":
        assert self.index_kind in ("ka", "kf")
        assert self.vsst_format in ("log", "btable", "rtable")
        assert self.ksst_format in ("btable", "dtable")
        assert self.gc_mode in ("standalone", "compaction")
        assert self.num_slots >= 1
        assert self.rebalance_threshold > 1.0
        assert self.placement_hysteresis >= 1.0
        assert 0 < self.placement_min_threshold <= self.placement_max_threshold
        assert self.placement_retune_interval >= 1
        assert self.placement_heat_boost >= 0
        assert self.placement_read_weight >= 0.0
        assert self.cache_ghost_ratio > 0.0
        assert 0.0 <= self.cache_quota_floor <= self.cache_quota_ceiling <= 1.0
        assert self.cache_retune_interval >= 1
        assert self.block_compression in ("none", "lz4")
        assert 0.0 < self.compression_min_ratio <= 1.0
        if self.bloom_bits_per_key is None:
            self.bloom_bits_per_key = self.bits_per_key
        assert self.bloom_bits_per_key >= 0
        assert self.obs_window_s > 0.0
        assert self.obs_series_len >= 1
        assert self.obs_sample_every >= 1
        if self.index_kind == "ka":
            assert self.vsst_format == "log", "KA addressing implies log vSSTs"
        return self

    def bloom_bits(self) -> int:
        """Effective filter bits/key (handles un-validated Options where
        ``bloom_bits_per_key`` is still the None sentinel)."""
        return (self.bits_per_key if self.bloom_bits_per_key is None
                else self.bloom_bits_per_key)


def preset(name: str, **over) -> Options:
    """Named systems from the paper's evaluation (Section IV) and the
    ablation ladder of Fig. 19/20."""
    presets = {
        # -- systems ------------------------------------------------------
        "rocksdb": dict(kv_separation=False),
        "blobdb": dict(index_kind="ka", vsst_format="log",
                       gc_mode="compaction", dca=False),
        "titan": dict(index_kind="ka", vsst_format="log",
                      write_back_index=True, dca=False),
        "terarkdb": dict(index_kind="kf", vsst_format="btable", dca=False),
        "scavenger": dict(index_kind="kf", vsst_format="rtable",
                          ksst_format="dtable", compensated_size=True,
                          dropcache=True),
        "scavenger_plus": dict(index_kind="kf", vsst_format="rtable",
                               ksst_format="dtable", compensated_size=True,
                               dropcache=True, adaptive_readahead=True,
                               dynamic_scheduler=True),
        "scavenger_plus_adaptive": dict(
            index_kind="kf", vsst_format="rtable", ksst_format="dtable",
            compensated_size=True, dropcache=True, adaptive_readahead=True,
            dynamic_scheduler=True, adaptive_placement=True,
            shared_cache=True, block_compression="lz4"),
        # -- ablation ladder (paper names) ---------------------------------
        "TDB": dict(index_kind="kf", vsst_format="btable", dca=False),
        "TDB-C": dict(index_kind="kf", vsst_format="btable",
                      compensated_size=True),
        "CR": dict(index_kind="kf", vsst_format="rtable",
                   compensated_size=True),
        "CRW": dict(index_kind="kf", vsst_format="rtable",
                    compensated_size=True, dropcache=True),
        "CRWL": dict(index_kind="kf", vsst_format="rtable",
                     ksst_format="dtable", compensated_size=True,
                     dropcache=True),
        "S-A": dict(index_kind="kf", vsst_format="rtable",
                    ksst_format="dtable", compensated_size=True,
                    dropcache=True, adaptive_readahead=True),
        "S-AD": dict(index_kind="kf", vsst_format="rtable",
                     ksst_format="dtable", compensated_size=True,
                     dropcache=True, adaptive_readahead=True,
                     dynamic_scheduler=True),
        "S-ADP": dict(index_kind="kf", vsst_format="rtable",
                      ksst_format="dtable", compensated_size=True,
                      dropcache=True, adaptive_readahead=True,
                      dynamic_scheduler=True, adaptive_placement=True),
        "S-CACHE": dict(index_kind="kf", vsst_format="rtable",
                        ksst_format="dtable", compensated_size=True,
                        dropcache=True, adaptive_readahead=True,
                        dynamic_scheduler=True, adaptive_placement=True,
                        shared_cache=True),
    }
    cfg = dict(presets[name])
    cfg.update(over)
    return Options(**cfg).validate()
