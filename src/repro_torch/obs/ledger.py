"""Amplification ledger: write-amp by source, space-amp by component.

The ledger is a *view* plus a windowed sampler — it does not add a
second instrumentation path.  Cumulative write bytes per source are
read from counters the engines already maintain (``SchedulerCore``
WAL accounting and per-job-kind background write bytes); space
components come from the attached stores' version sets.  The only
thing the ledger accumulates itself is the denominator: logical user
bytes, bumped unconditionally on the foreground write path (one
integer add per op).

Stores attach by shard tag; recovery re-attaches under the same tag
and *replaces* the stale store object, so nothing double-counts.  The
ledger itself lives on the device's :class:`MetricsRegistry` and
therefore survives crash/recovery like every other monotonic counter.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

WRITE_SOURCES = ("wal", "flush", "compaction", "gc", "migration")

# SchedulerCore.bg_write_bytes keys -> ledger source names.
_BG_KINDS = (("flush", "flush"), ("compaction", "compaction"),
             ("gc", "gc"), ("migrate", "migration"))


class AmplificationLedger:
    def __init__(self) -> None:
        self.user_bytes = 0
        self.user_ops = 0
        self.stores: Dict[int, object] = {}       # shard tag -> KVStore
        self.core = None                          # shared SchedulerCore
        self.window_s = 0.5
        self.series: Deque[Dict[str, object]] = deque(maxlen=256)
        self._last_t = 0.0
        self._last_writes: Optional[Dict[str, int]] = None
        self._last_user = 0

    def attach(self, tag: int, store) -> None:
        self.stores[tag] = store
        self.core = store.sched.core
        opts = store.opts
        self.window_s = getattr(opts, "obs_window_s", self.window_s)
        maxlen = getattr(opts, "obs_series_len", None)
        if maxlen and maxlen != self.series.maxlen:
            self.series = deque(self.series, maxlen=maxlen)

    # -- cumulative write bytes per source ----------------------------
    def write_sources(self) -> Dict[str, int]:
        core = self.core
        if core is None:
            return {k: 0 for k in WRITE_SOURCES}
        bg = core.bg_write_bytes
        out = {"wal": int(core.wal_bytes)}
        for kind, name in _BG_KINDS:
            out[name] = int(bg.get(kind, 0))
        return out

    # -- space components (caller holds the engine lock) --------------
    def space_components(self) -> Dict[str, int]:
        index = live = total = files = filt = 0
        device = None
        for store in self.stores.values():
            v = store.versions
            device = store.device
            index += sum(v.index_level_sizes())
            tot_v, live_v = v.value_stats()
            total += tot_v
            live += live_v
            files += sum(m.file_size for m in v.vssts.values())
            bpk = getattr(store.opts, "bloom_bits_per_key", 0) or 0
            if bpk:
                entries = sum(f.num_entries for lvl in v.levels for f in lvl)
                entries += sum(m.num_entries for m in v.vssts.values())
                filt += (entries * bpk) // 8
        dev_total = device.total_bytes() if device is not None else 0
        return {
            "index_bytes": index,
            "value_live_bytes": live,
            "value_garbage_bytes": max(0, total - live),
            "value_file_bytes": files,
            "filter_bytes": filt,
            # WAL segments, superblock frames, manifests — everything on
            # the device that is neither index tables nor value logs.
            "other_bytes": max(0, dev_total - index - files),
            "device_total_bytes": dev_total,
        }

    # -- windowed time series -----------------------------------------
    def maybe_sample(self, now: float) -> None:
        """Record one window if ``window_s`` sim-seconds have elapsed.

        Called from the engines' background pump under the engine lock;
        cheap when the window has not rolled over.
        """
        if now - self._last_t < self.window_s:
            return
        writes = self.write_sources()
        prev = self._last_writes or {k: 0 for k in WRITE_SOURCES}
        self.series.append({
            "t": now,
            "user_bytes": self.user_bytes - self._last_user,
            "writes": {k: writes[k] - prev.get(k, 0) for k in WRITE_SOURCES},
            "space": self.space_components(),
        })
        self._last_t = now
        self._last_writes = writes
        self._last_user = self.user_bytes

    # -- snapshot ------------------------------------------------------
    def snapshot(self, *, series: bool = True) -> Dict[str, object]:
        writes = self.write_sources()
        ub = max(1, self.user_bytes)
        total_w = sum(writes.values())
        comps = self.space_components()
        live = max(1, comps["value_live_bytes"] + comps["index_bytes"])
        out: Dict[str, object] = {
            "user_bytes": self.user_bytes,
            "user_ops": self.user_ops,
            "write_bytes": writes,
            "wa_by_source": {k: v / ub for k, v in writes.items()},
            "wa_total": total_w / ub,
            "space": comps,
            "sa_by_component": {k: comps[k] / live
                                for k in ("index_bytes", "value_live_bytes",
                                          "value_garbage_bytes",
                                          "filter_bytes", "other_bytes")},
            "sa_total": comps["device_total_bytes"] / live,
        }
        if series:
            out["series"] = list(self.series)
        return out


__all__ = ["AmplificationLedger", "WRITE_SOURCES"]
