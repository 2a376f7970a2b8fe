"""Online shard rebalancing: slot-map routing + GC-riding migration jobs.

The paper's premise is that GC/compaction policy must adapt to workload
skew; with a fixed ``crc32 % n_shards`` router a hot tenant permanently
overloads one shard's memtable, GC pressure and cache slice.  This module
makes shard membership *mutable* without rehashing the world:

* **Slot routing** — keys hash into ``Options.num_slots`` fixed slots
  (``crc32 % S``); a slot map (slot → shard) owned by the front-end does
  the final hop.  Moving data means re-pointing one slot, never changing
  the key hash.
* **Migration jobs** — a :class:`Rebalancer` schedules ``JOB_MIGRATE``
  through the shared :class:`~.scheduler.SchedulerCore` (admission, lanes
  and the GC bandwidth governor arbitrate it exactly like GC).  One job
  moves one slot: the source shard's *index* is scanned for the slot's
  keys first and values are fetched only for proven-live records — the
  same lazy-read / valid-bitmap discipline Scavenger+ GC uses instead of
  Titan-style whole-file rewrites — then copies ride the target's normal
  write path (WAL + memtable + flush), charged to the GC I/O classes so
  the bandwidth governor throttles migration exactly like GC traffic.
* **Epoch commit** — routing changes only when the job's effects append a
  single superblock frame ``{epoch, slot_map, move}``; a crash at any
  earlier point recovers to the pre-commit epoch with the slot still on
  its source shard (copies already on the target are orphans that the
  provenance-filtered read path never surfaces).
* **GC-riding cleanup** — after the commit the source's copies are
  tombstoned through the index write path; compaction drops the shadowed
  entries (turning the bytes into *exposed* garbage) and standalone GC
  reclaims them — no in-place file rewrites, the space-time argument the
  paper makes against Titan-style GC.

The balancer policy (:meth:`Rebalancer.maybe_rebalance`) fires from the
front-end's background hooks: when per-shard write-byte load diverges past
``Options.rebalance_threshold`` x mean it proposes moving the hottest
fitting slot from the most- to the least-loaded shard, one slot at a time.
"""

from __future__ import annotations

import heapq as _heapq
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..store.device import IOClass
from ..store.format import VT_DELETE, VT_VALUE, entry_value_size
from .scheduler import JOB_MIGRATE

DEFAULT_SLOTS = 256

Entry = Tuple[bytes, int, int, bytes]   # (ukey, seq, vtype, payload)


def slot_of(ukey: bytes, n_slots: int = DEFAULT_SLOTS) -> int:
    """Deterministic key → slot hash (CRC32, unsalted — stable across
    processes and restarts; the slot count never changes for a device)."""
    return zlib.crc32(ukey) % n_slots


def default_slot_map(n_shards: int, n_slots: int = DEFAULT_SLOTS
                     ) -> List[int]:
    """Round-robin initial placement.  When ``n_shards`` divides
    ``n_slots`` this reproduces the legacy ``crc32 % n_shards`` routing
    exactly (``(c % S) % n == c % n`` for ``n | S``), which is what makes
    v1 superblocks upgradable in place."""
    return [s % n_shards for s in range(n_slots)]


# ---------------------------------------------------------------------------
# Slot-filtered index iteration (the migration read plan)
# ---------------------------------------------------------------------------

def _mem_stream(m) -> Iterator[Entry]:
    for k, (seq, vt, pl) in m.sorted_items():
        yield (k, seq, vt, pl)


def _newest_per_key(streams: List[Iterator[Entry]]) -> Iterator[Entry]:
    prev: Optional[bytes] = None
    for e in _heapq.merge(*streams, key=lambda e: (e[0], -e[1])):
        if e[0] == prev:
            continue
        prev = e[0]
        yield e


def mem_slot_entries(db, slot: int, n_slots: int) -> Iterator[Entry]:
    """Newest version per key for one slot, memtables only — the catch-up
    delta when the source has not flushed since the copy watermark."""
    streams = [_mem_stream(db.mem)]
    for m, _ in db.immutables:
        streams.append(_mem_stream(m))
    for e in _newest_per_key(streams):
        if slot_of(e[0], n_slots) == slot:
            yield e


def slot_entries(db, slot: int, n_slots: int,
                 cls: IOClass = IOClass.GC_READ) -> Iterator[Entry]:
    """Newest version per key for one slot, merged over the shard's
    memtables and all index levels (``KVStore.entry_streams`` — the same
    sources the user scan iterates, charged to the GC read class).  Only
    *index* blocks are read here (keys + entry payloads); whoever
    consumes the entries decides which values to fetch — the lazy-read
    split of the Scavenger+ GC plan."""
    for e in _newest_per_key(db.entry_streams(b"", cls)):
        if slot_of(e[0], n_slots) == slot:
            yield e


# ---------------------------------------------------------------------------
# The rebalancer
# ---------------------------------------------------------------------------

class Rebalancer:
    """Per-front-end migration driver + load-balancing policy.

    Owns the in-flight slot table (slot → target shard id) that the
    front-end's dual-routed reads consult, the per-slot write-byte
    accounting the policy trigger uses, and the ``stats()["rebalance"]``
    counters.
    """

    def __init__(self, store) -> None:
        self.store = store
        self.inflight: Dict[int, int] = {}       # slot -> dst shard id
        self.slot_bytes = [0] * store.n_slots    # cumulative written bytes
        self.slot_live = [0] * store.n_slots     # approx live bytes by slot
        self._key_bytes: Dict[bytes, int] = {}   # key -> last live size
        self._deferred: List = []                # commits parked by the guard
        # Leaf mutexes (level 3, see core.concurrency): _acct_mu guards
        # the per-slot accounting and window-delete sets (mutated by
        # routed ops on any client thread); _defer_mu guards the deferred
        # -commit list (appended under pump, drained at guard exit).
        # Neither is ever held across an acquire of a higher-level lock.
        self._acct_mu = threading.Lock()
        self._defer_mu = threading.Lock()
        # Keys of an in-flight slot whose *final* user op in the
        # migration window was a delete (a put discards the key again).
        # Compaction may drop a bottom-level tombstone before the commit
        # catch-up runs, leaving no trace on the source — this set is the
        # durable-enough record (the window dies with a crash, but so
        # does the routing flip) that keeps the target's stale copy from
        # resurrecting the key.
        self.window_deletes: Dict[int, set] = {}  # slot -> {key}
        # Registry-backed (a plain dict at runtime): monotonic across a
        # crash/recovery cycle that reuses the device, like shard
        # counters.
        self.counters: Dict[str, int] = store.device.metrics.counters(
            "rebalance", {
                "proposals": 0, "migrations": 0, "slots_moved": 0,
                "keys_moved": 0, "bytes_moved": 0, "catchup_keys": 0,
                "window_deletes": 0, "keys_cleaned": 0, "cleanups": 0,
                "aborted_cleanups": 0, "deferred_commits": 0,
            })

    # -- load accounting -------------------------------------------------
    # Two views per slot: cumulative write bytes (the write-rate signal)
    # and approximate live bytes (last value size per key — the router's
    # cheap stand-in for the engine's value_live accounting, which lags
    # behind until compaction exposes overwritten bytes).  The policy
    # balances live bytes; both views are exported in stats.  The per-key
    # size map costs O(live keys) front-end memory, so accounting only
    # runs with the balancer enabled; it restarts empty after a crash
    # recovery and is repopulated by traffic.

    def note_put(self, slot: int, ukey: bytes, nbytes: int) -> None:
        if not self.store.opts.rebalance:
            return
        with self._acct_mu:
            self.slot_bytes[slot] += nbytes
            old = self._key_bytes.get(ukey)
            if old is not None:
                self.slot_live[slot] -= old
            self._key_bytes[ukey] = nbytes
            self.slot_live[slot] += nbytes

    def note_delete(self, slot: int, ukey: bytes) -> None:
        if not self.store.opts.rebalance:
            return
        with self._acct_mu:
            self.slot_bytes[slot] += len(ukey)
            old = self._key_bytes.pop(ukey, None)
            if old is not None:
                self.slot_live[slot] -= old

    def seed_from_index(self) -> int:
        """Rebuild the per-slot live-byte accounting from the recovered
        index — one recovery-time sweep over each shard's entry streams
        (keys + entry payloads only; a KF/KA entry carries the value
        size, so no value reads).  Without this a freshly recovered
        store reports zero load everywhere and cannot rebalance until
        new traffic repopulates the counters (ex-ROADMAP open item).
        Runs synchronously inside recovery — the store is not serving
        yet, so charging the scan there (GC read class, like every
        other index sweep) is the cheapest moment it will ever have.
        Returns the number of live keys seeded."""
        store = self.store
        if not store.opts.rebalance:
            return 0
        n = 0
        for shard in store.shards:
            for e in _newest_per_key(
                    shard.entry_streams(b"", IOClass.GC_READ)):
                if e[2] == VT_DELETE:
                    continue
                size = len(e[0]) + entry_value_size(e[2], e[3])
                slot = slot_of(e[0], store.n_slots)
                with self._acct_mu:
                    old = self._key_bytes.get(e[0])
                    if old is not None:     # seeding is idempotent
                        self.slot_live[slot] -= old
                    self._key_bytes[e[0]] = size
                    self.slot_live[slot] += size
                n += 1
        return n

    # -- migration-window routing hooks (active regardless of the policy
    # knob — manual migrations need them too) ---------------------------
    def note_route_put(self, slot: int, ukey: bytes) -> None:
        with self._acct_mu:
            wd = self.window_deletes.get(slot)
            if wd is not None:
                wd.discard(ukey)

    def note_route_delete(self, slot: int, ukey: bytes) -> None:
        with self._acct_mu:
            wd = self.window_deletes.get(slot)
            if wd is not None:
                wd.add(ukey)

    def routing_view(self) -> Tuple[int, List[int], Dict[int, int]]:
        """One consistent ``(epoch, slot_map, inflight)`` triple — what a
        cross-shard MVCC snapshot captures.  Must be called with the
        routing guard held (read side suffices: epoch commits take the
        write side, so the triple cannot change mid-copy).

        Snapshot reads route by the *captured* map and never dual-route:
        at capture the map's owner held every version ``<=`` that
        shard's bound, and retention (``core.mvcc``) keeps those
        versions — catch-up copies land on the target and cleanup
        tombstones on the source all carry sequences above the bound,
        so they are invisible to the snapshot even after the epoch
        flips."""
        return (self.store.epoch, list(self.store.slot_map),
                dict(self.inflight))

    def is_window_deleted(self, slot: int, ukey: bytes) -> bool:
        with self._acct_mu:
            wd = self.window_deletes.get(slot)
            return wd is not None and ukey in wd

    def _loads(self, per_slot: List[int]) -> List[int]:
        with self._acct_mu:
            per_slot = list(per_slot)
        loads = [0] * self.store.n_shards
        for slot, owner in enumerate(self.store.slot_map):
            loads[owner] += per_slot[slot]
        return loads

    def shard_loads(self) -> List[int]:
        """Per-shard approximate live-byte load under the current slot
        map.  A committed move carries its slot's accounting with it, so
        the metric reflects the new balance immediately."""
        return self._loads(self.slot_live)

    def shard_write_loads(self) -> List[int]:
        """Per-shard cumulative write-byte load (the write-rate view)."""
        return self._loads(self.slot_bytes)

    # -- policy ---------------------------------------------------------
    def maybe_rebalance(self) -> Optional[int]:
        """Propose one slot move when per-shard load diverges; returns the
        migrating slot or None.  Fired from the front-end's background
        hooks (job-completion waiters + a per-N-ops tick).  Runs under
        the engine lock: admission, the superblock append and the job
        launch are all engine state."""
        store = self.store
        if not store.opts.rebalance:
            return None
        with store.sched_core.engine_lock:
            return self._maybe_rebalance_locked()

    def _maybe_rebalance_locked(self) -> Optional[int]:
        store = self.store
        if self.inflight or store.n_shards < 2:
            return None
        if not store.sched.can_admit(JOB_MIGRATE):
            return None
        loads = self.shard_loads()
        total = sum(loads)
        if total < store.opts.rebalance_min_bytes:
            return None
        mean = total / store.n_shards
        hot = max(range(store.n_shards), key=loads.__getitem__)
        cold = min(range(store.n_shards), key=loads.__getitem__)
        if hot == cold or loads[hot] <= store.opts.rebalance_threshold * mean:
            return None
        gap = loads[hot] - loads[cold]
        cands = [s for s, owner in enumerate(store.slot_map)
                 if owner == hot and self.slot_live[s] > 0]
        if not cands:
            return None
        # Biggest slot that does not overshoot the midpoint; if every slot
        # overshoots, the smallest one — unless even that would just swap
        # the roles of hot and cold (ping-pong guard).
        fit = [s for s in cands if self.slot_live[s] <= gap / 2]
        if fit:
            slot = max(fit, key=lambda s: self.slot_live[s])
        else:
            slot = min(cands, key=lambda s: self.slot_live[s])
            if self.slot_live[slot] >= gap:
                return None
        self.counters["proposals"] += 1
        if not self.start_migration(slot, cold):
            return None
        return slot

    # -- migration lifecycle ---------------------------------------------
    def start_migration(self, slot: int, dst_id: int) -> bool:
        """Schedule a JOB_MIGRATE moving ``slot`` to shard ``dst_id``.
        The job body copies eagerly; routing changes only in its effects
        (the epoch commit) when the job's lane completes."""
        store = self.store
        with store.sched_core.engine_lock:
            src_id = store.slot_map[slot]
            if dst_id == src_id or slot in self.inflight:
                return False
            if not store.sched.can_admit(JOB_MIGRATE):
                return False
            # Durable intent: if the job's copies land but the epoch
            # commit never does (crash), recovery matches this frame
            # against the committed moves and tombstones the orphan
            # copies on the target.
            store._append_superblock({"version": 2,
                                      "mig_start": [slot, src_id, dst_id]})
            self.inflight[slot] = dst_id
            with self._acct_mu:
                self.window_deletes[slot] = set()
            self.counters["migrations"] += 1
            tracer = store.sched_core.tracer
            if tracer is not None:
                tracer.instant("rebalance", "migrate_start",
                               args={"slot": slot, "src": src_id,
                                     "dst": dst_id})
            store.sched.run_job(
                JOB_MIGRATE, lambda: self._migrate_body(slot, src_id, dst_id),
                trace_args={"slot": slot, "src": src_id, "dst": dst_id})
            return True

    def _migrate_body(self, slot: int, src_id: int, dst_id: int):
        store = self.store
        src = store.shards[src_id]
        dst = store.shards[dst_id]
        # No pre-clear of the target is needed: orphan copies only arise
        # from a pre-commit crash, and recovery sweeps every migration
        # intent without a matching commit (clear_aborted) before the
        # store serves traffic — so in any reachable state the target
        # holds no stale live entries for this slot, and scanning its
        # whole index here would just burn governed GC read bandwidth.
        watermark = src.versions.seq
        flush_mark = src.stats_counters["flushes"]
        seen: Set[bytes] = set()
        moved_keys = moved_bytes = 0
        # Lazy-read copy: keys from the index first, then values only for
        # the slot's live records (rtable sources resolve through the
        # dense-index record read, never a whole-file scan).
        for e in list(slot_entries(src, slot, store.n_slots)):
            seen.add(e[0])
            if e[2] == VT_DELETE:
                continue
            val = src._resolve_value(e, IOClass.GC_READ)
            if val is None:
                continue
            dst.write_index_entry(e[0], VT_VALUE, val, IOClass.GC_WRITE_INDEX)
            moved_keys += 1
            moved_bytes += len(val)
        self.counters["keys_moved"] += moved_keys
        self.counters["bytes_moved"] += moved_bytes

        def effects(elapsed: float = 0.0) -> None:
            # The epoch commit may fire from a pump() *inside* a routed
            # front-end op (the op read slot_map before its record landed
            # on the source).  Committing there would flip routing under
            # the in-flight record and lose it past the catch-up scan —
            # so while any front-end op holds a routing read hold, park
            # the commit; the guard exit that leaves the routing lock
            # idle runs it, at which point the op's record is in the
            # source memtable and catch-up copies it.
            #
            # try_acquire_write only: effects run under the engine lock
            # (level 2) and the routing lock is level 0 — a *blocking*
            # out-of-order acquire could deadlock against active readers;
            # a non-blocking probe cannot.
            def commit() -> None:
                self._commit(slot, src_id, dst_id, watermark, flush_mark,
                             seen)

            if self.store.routing.try_acquire_write():
                try:
                    commit()
                finally:
                    self.store.routing.release_write()
            else:
                with self._defer_mu:
                    self._deferred.append(commit)
                self.counters["deferred_commits"] += 1

        return effects

    def run_deferred(self) -> None:
        """Run commits parked while front-end ops held the routing guard
        (called by the guard exit that left the routing lock idle, and by
        the op tick).  Exclusive routing access is re-probed here — if a
        new reader slipped in, *its* exit retries.  A completed commit
        re-evaluates the policy immediately — the job-completion waiter
        that would normally do so fired while the commit was parked."""
        with self._defer_mu:
            if not self._deferred:
                return
        if not self.store.routing.try_acquire_write():
            return
        ran = False
        try:
            with self.store.sched_core.engine_lock:
                while True:
                    with self._defer_mu:
                        if not self._deferred:
                            break
                        fn = self._deferred.pop(0)
                    fn()
                    ran = True
        finally:
            self.store.routing.release_write()
        if ran:
            self.maybe_rebalance()

    def _commit(self, slot: int, src_id: int, dst_id: int, watermark: int,
                flush_mark: int, seen: Set[bytes]) -> None:
        store = self.store
        src = store.shards[src_id]
        dst = store.shards[dst_id]
        # Deferred commits run outside run_job's attribution scope — tag
        # the catch-up/cleanup writes as migration, not generic GC.
        with src.device.attribute_gc_writes(JOB_MIGRATE):
            self._commit_attributed(slot, src_id, dst_id, watermark,
                                    flush_mark, seen)

    def _commit_attributed(self, slot: int, src_id: int, dst_id: int,
                           watermark: int, flush_mark: int,
                           seen: Set[bytes]) -> None:
        store = self.store
        src = store.shards[src_id]
        dst = store.shards[dst_id]
        # Catch-up: user writes routed to the source while the copy was in
        # flight (seq above the watermark).  Unless the source flushed in
        # the window they are still in its memtables — no device I/O.
        if src.stats_counters["flushes"] != flush_mark:
            delta = list(slot_entries(src, slot, store.n_slots))
        else:
            delta = list(mem_slot_entries(src, slot, store.n_slots))
        catchup = 0
        for e in delta:
            if e[1] <= watermark:
                continue
            seen.add(e[0])
            catchup += 1
            val = (None if e[2] == VT_DELETE
                   else src._resolve_value(e, IOClass.GC_READ))
            if val is None:
                dst.write_index_entry(e[0], VT_DELETE, b"",
                                      IOClass.GC_WRITE_INDEX)
            else:
                dst.write_index_entry(e[0], VT_VALUE, val,
                                      IOClass.GC_WRITE_INDEX)
        self.counters["catchup_keys"] += catchup
        # Window deletes whose tombstone left no trace on the source
        # (bottom-level compaction drops tombstones): the catch-up above
        # cannot see them, so replay them onto the target from the
        # front-end's window record — before the epoch frame, so the
        # flip never exposes the stale copy.
        # (last-op-wins: a put after the delete removed the key from the
        # set, so an unconditional tombstone can never shadow newer data)
        with self._acct_mu:
            window = self.window_deletes.pop(slot, ())
        for k in sorted(window):
            dst.write_index_entry(k, VT_DELETE, b"", IOClass.GC_WRITE_INDEX)
            seen.add(k)
            self.counters["window_deletes"] += 1
        # Epoch commit: ONE atomic superblock frame re-points the slot.  A
        # crash before this append recovers to the pre-commit epoch; a
        # torn frame is discarded by the superblock replay.
        new_map = list(store.slot_map)
        new_map[slot] = dst_id
        store.epoch += 1
        store._append_superblock({"version": 2, "epoch": store.epoch,
                                  "slot_map": new_map,
                                  "move": [slot, src_id, dst_id]})
        store.slot_map = new_map
        self.inflight.pop(slot, None)
        self.counters["slots_moved"] += 1
        tracer = store.sched_core.tracer
        if tracer is not None:
            tracer.instant("rebalance", "epoch_commit",
                           args={"slot": slot, "epoch": store.epoch})
        # GC-riding cleanup: tombstone the moved keys on the source so
        # compaction drops the shadowed entries (hidden → exposed garbage)
        # and standalone GC reclaims the value bytes.
        self._cleanup(src, seen)
        store._append_superblock({"version": 2, "cleaned": store.epoch})
        self.counters["cleanups"] += 1

    def _cleanup(self, src, keys) -> None:
        n = 0
        for k in sorted(keys):
            cur = src.mem_lookup(k)
            if cur is not None and cur[1] == VT_DELETE:
                continue                      # already tombstoned
            src.write_index_entry(k, VT_DELETE, b"", IOClass.GC_WRITE_INDEX)
            n += 1
        self.counters["keys_cleaned"] += n

    def resume_cleanup(self, slot: int, src_id: int) -> None:
        """Recovery found a committed move without its ``cleaned`` marker:
        re-issue the source cleanup (idempotent — keys the pre-crash
        cleanup already tombstoned are skipped) and mark it done."""
        store = self.store
        src = store.shards[src_id]
        with src.device.attribute_gc_writes(JOB_MIGRATE):
            keys = [e[0] for e in slot_entries(src, slot, store.n_slots)
                    if e[2] != VT_DELETE]
            self._cleanup(src, keys)
        store._append_superblock({"version": 2, "cleaned": store.epoch})
        self.counters["cleanups"] += 1

    def clear_aborted(self, slot: int, dst_id: int) -> None:
        """Recovery found a migration intent with no matching commit: the
        crashed job may have left orphan copies on its target.  Tombstone
        them (unless the slot legitimately lives there now) and append an
        abort marker so later recoveries do not re-sweep."""
        store = self.store
        if store.slot_map[slot] != dst_id:
            dst = store.shards[dst_id]
            with dst.device.attribute_gc_writes(JOB_MIGRATE):
                keys = [e[0] for e in slot_entries(dst, slot, store.n_slots)
                        if e[2] != VT_DELETE]
                self._cleanup(dst, keys)
            self.counters["aborted_cleanups"] += 1
        store._append_superblock({"version": 2, "mig_abort": [slot, dst_id]})

    # -- reporting --------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {"epoch": self.store.epoch,
                "n_slots": self.store.n_slots,
                "inflight": dict(self.inflight),
                "shard_live_loads": self.shard_loads(),
                "shard_write_loads": self.shard_write_loads(),
                **self.counters}
