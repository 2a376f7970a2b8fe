"""Sharded multi-tenant front-end: N KVStore shards behind one device.

Real KV-separated deployments (Titan/TerarkDB as evaluated in the paper)
run many column-family/shard instances over a single SSD and a single
background-thread pool.  ``ShardedKVStore`` reproduces that topology:

* user keys hash into ``Options.num_slots`` fixed *slots* (deterministic
  CRC32, stable across processes and restarts); a **slot map** (slot →
  shard) does the final routing hop, so shard membership can change
  online — the :mod:`.rebalance` subsystem migrates one slot at a time
  and re-points it with an epoch commit, no world rehash;
* all shards share one :class:`BlockDevice`, one simulated clock and one
  :class:`SchedulerCore` — flush/compaction/GC/migration admission, the
  dynamic GC thread allocation (eqs. 4-6 over *summed* shard pressures)
  and the GC bandwidth governor are arbitrated globally, so a GC-heavy
  shard competes with its neighbours for lanes exactly as column families
  compete for RocksDB ``Env`` threads;
* batched APIs (``write_batch`` / ``multi_get`` / merged ``scan``) route
  per shard, preserving per-key ordering (a key always hashes to the same
  slot); reads dual-route source-then-target for slots with an in-flight
  migration, and the merged scan filters every candidate by the shard its
  key *currently* routes to, so migration copies and pre-cleanup orphans
  never surface twice;
* cross-shard **MVCC snapshots** (``snapshot()``): one sequence bound
  per shard captured under the batch *apply gate*, so a multi-shard
  ``write_batch`` is visible all-or-nothing; ``multi_get`` and the
  merged ``scan`` pin an implicit snapshot, making them torn-read
  free, and ``read_modify_write`` / ``compare_and_swap`` give
  validated atomic updates (YCSB-F) through the same commit pipeline
  (see :mod:`.mvcc`);
* all shards commit through one :class:`~.commitlog.GroupCommitLog`:
  a ``write_batch`` opens a commit group so the whole cross-shard batch
  is coalesced into a single framed segment append — **one** WAL sync per
  batch instead of one per record (records carry a shard tag; per-shard
  sequence stamping is preserved);
* a *superblock* — always fid 1, the first file created — is an
  append-only frame log.  The base frame records the shard count, slot
  count, initial slot map and each shard's manifest fid; every completed
  migration appends one ``{epoch, slot_map, move}`` frame (the atomic
  epoch commit) and one ``{cleaned}`` frame once the source copies are
  tombstoned.  ``recover=True`` replays the frames (v1 superblocks from
  the fixed-routing era decode to the default slot map), then each
  shard's manifest, then routes the interleaved commit-log segments back
  to their shards by tag (torn tails tolerated everywhere).

Per-shard memtables follow RocksDB column-family semantics (each shard
owns one); the block cache is ONE device-wide
:class:`~.cache.SharedReadCache` — every shard attaches through a
:class:`~.cache.ShardCacheHandle`, per-shard admission quotas sum
exactly to the configured budget, and with ``Options.shared_cache`` on
the quotas re-tune online from ghost-cache marginal utility (a read-hot
tenant's slice grows at the expense of idle neighbours; off, the quotas
stay at the static even split of the pre-shared-cache era).
"""

from __future__ import annotations

import heapq as _heapq
import threading
from contextlib import contextmanager
from typing import (Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import msgpack

from ..obs import AuditReport, TraceRecorder, audit_snapshot
from ..store.device import BlockDevice, Clock, CostModel, IOClass
from ..store.format import VT_DELETE, VT_VALUE
from .cache import SharedReadCache
from .commitlog import CSN_TAG, GroupCommitLog
from .concurrency import RWLock
from .db import KVStore, validate_batch_ops
from .mvcc import Snapshot
from .options import Options
from .rebalance import (DEFAULT_SLOTS, Rebalancer, default_slot_map, slot_of)
from .scheduler import Scheduler, SchedulerCore

SUPERBLOCK_FID = 1

WriteOp = Tuple  # ('put', key, value) | ('del', key)

#: How many routed ops between balancer policy checks (the other trigger
#: is the scheduler-core waiter, fired on every background-job completion).
REBALANCE_TICK_OPS = 128


def shard_of(ukey: bytes, n_shards: int) -> int:
    """Legacy helper: routing under the *default* slot map (slot → slot %
    n).  Deterministic and stable; equals the pre-slot ``crc32 % n``
    routing whenever ``n_shards`` divides ``DEFAULT_SLOTS``."""
    return slot_of(ukey, DEFAULT_SLOTS) % n_shards


class ShardedKVStore:
    def __init__(self, opts: Options, n_shards: int = 4,
                 device: Optional[BlockDevice] = None,
                 recover: bool = False) -> None:
        self.opts = opts.validate()
        self.device = device or BlockDevice(Clock(), CostModel())
        self.clock = self.device.clock
        self.sched_core = SchedulerCore(self.clock, self.device, opts)
        # Front-end view over the shared core: migration jobs run here.
        self.sched = Scheduler(self.clock, self.device, opts,
                               core=self.sched_core)
        self.shards: List[KVStore] = []
        self._on_user_write: Optional[Callable[[bytes, int, bytes], None]] \
            = None
        self._ops_since_rebalance = 0
        self._tick_mu = threading.Lock()
        # Routing epoch lock (level 0 of the hierarchy, see
        # core.concurrency): routed ops hold the read side, migration
        # epoch commits need the write side (taken with try_acquire_write
        # only — they defer rather than block).
        self.routing = RWLock()
        # Apply gate (level 0.5, between routing and the shard latches):
        # write_batch holds it across the whole multi-shard apply loop and
        # snapshot capture takes it before reading the per-shard sequence
        # bounds, so a snapshot's bounds vector can never split a batch —
        # it observes every shard either before or after the entire batch.
        self._apply_gate = threading.RLock()
        self._snapshots_taken = 0
        self._open_snapshots = 0
        pending_cleanup: Optional[Tuple[int, int, int]] = None
        if recover:
            sb = self._read_superblock()
            n_shards = sb["n_shards"]
            self.n_slots = sb["n_slots"]
            self.slot_map = list(sb["slot_map"])
            self.epoch = sb["epoch"]
            pending_cleanup = sb["pending_cleanup"]
            self.commitlog = GroupCommitLog(self.device,
                                            core=self.sched_core)
            self.cache = SharedReadCache.from_options(opts,
                                                      n_shards=n_shards)
            for tag, mf in enumerate(sb["manifests"]):
                self.shards.append(
                    KVStore(opts, device=self.device, recover=True,
                            sched_core=self.sched_core, manifest_fid=mf,
                            commit_log=self.commitlog, shard_tag=tag,
                            cache=self.cache.handle(tag)))
            self._replay_segments(n_shards)
        else:
            fid = self.device.create()
            if fid != SUPERBLOCK_FID:
                raise RuntimeError(
                    "ShardedKVStore must be created on a fresh device "
                    f"(first fid is {fid}, expected {SUPERBLOCK_FID})")
            self.commitlog = GroupCommitLog(self.device,
                                            core=self.sched_core)
            self.n_slots = opts.num_slots
            self.slot_map = default_slot_map(n_shards, self.n_slots)
            self.epoch = 0
            self.cache = SharedReadCache.from_options(opts,
                                                      n_shards=n_shards)
            for tag in range(n_shards):
                self.shards.append(
                    KVStore(opts, device=self.device,
                            sched_core=self.sched_core,
                            commit_log=self.commitlog, shard_tag=tag,
                            cache=self.cache.handle(tag)))
            self._append_superblock(
                {"version": 2, "epoch": 0, "n_shards": n_shards,
                 "n_slots": self.n_slots, "slot_map": self.slot_map,
                 "manifests": [s.versions.manifest_fid
                               for s in self.shards]})
        self.n_shards = n_shards
        # Observability: registry + ledger shared with the shards via the
        # device; the cache's adaptive quota retunes show up as trace
        # instant events when a recorder is active.
        self.obs = self.device.metrics
        if opts.obs_sampling:
            self.obs.sampling = True
        self.cache.on_retune = self._trace_cache_retune
        self.rebalancer = Rebalancer(self)
        if pending_cleanup is not None:
            # A move committed but crashed before tombstoning the source
            # copies — finish the cleanup now (idempotent).
            slot, src_id, _dst = pending_cleanup
            self.rebalancer.resume_cleanup(slot, src_id)
        if recover:
            # Migration intents with no matching commit: the crashed job
            # may have left orphan copies on its target — sweep them.
            for slot, _src, dst in sb["pending_intents"]:
                self.rebalancer.clear_aborted(slot, dst)
            if self.opts.rebalance:
                # Balancer accounting across restarts (ex-ROADMAP item):
                # the per-slot live view restarts empty, so seed it with
                # one background index sweep and let the policy act —
                # a skewed store can now rebalance straight out of
                # recovery instead of waiting for new traffic.
                self.rebalancer.seed_from_index()
                self.rebalancer.maybe_rebalance()
        self.sched_core.add_waiter(self.rebalancer.maybe_rebalance)

    def _replay_segments(self, n_shards: int) -> None:
        """Crash recovery: replay interleaved commit-log segments, routing
        each record to its shard by tag.  Segments go in fid (creation)
        order and records in append order, so per-shard sequence order is
        preserved; a shard that already flushed a segment's records has
        logged ``wal_done`` and skips it.  Torn tails are tolerated by
        ``GroupCommitLog.replay``; a tag outside the superblock's shard
        count is a hard error (stale superblock).

        CSN recovery: each coalesced segment append starts with a
        ``CSN_TAG`` stamp frame carrying the round's commit sequence
        number; the manifest-persisted per-shard floor covers rounds whose
        segments were already flushed and deleted.  The recovered CSN is
        the max over both, so it is monotonic across crashes."""
        self.commitlog.csn = max(s.versions.csn for s in self.shards)
        pending: Dict[int, set] = {}
        for tag, s in enumerate(self.shards):
            for fid in s.versions.pending_wals:
                pending.setdefault(fid, set()).add(tag)
        for s in self.shards:
            s.versions.pending_wals.clear()
        # Re-log every surviving record through its shard's sink (one
        # commit group — a single coalesced append into the fresh active
        # segment) so recovered memtable state is durable again and a
        # second crash before the next flush replays it identically.
        # time_free: replay I/O stays off the clock and a corrupt segment
        # (the RuntimeError below) cannot leave time charging disabled.
        with self.device.time_free():
            with self.commitlog.group():
                for fid in sorted(pending):
                    if not self.device.exists(fid):
                        continue
                    for tag, ukey, seq, vtype, payload in \
                            GroupCommitLog.replay(self.device, fid):
                        if tag == CSN_TAG:
                            self.commitlog.csn = max(self.commitlog.csn, seq)
                            continue
                        if tag >= n_shards:
                            raise RuntimeError(
                                f"commit-log segment {fid} carries shard "
                                f"tag {tag} but the superblock says "
                                f"n_shards={n_shards}: stale superblock / "
                                "shard-count mismatch — refusing to recover")
                        if tag in pending[fid]:
                            shard = self.shards[tag]
                            shard.versions.seq = max(shard.versions.seq, seq)
                            shard.sink.append(ukey, seq, vtype, payload)
                            shard.mem.put(ukey, seq, vtype, payload)
                    self.device.delete(fid)

    # ==================================================================
    # Superblock (append-only frame log, versioned decode)
    # ==================================================================

    def _append_superblock(self, record: dict) -> None:
        """Append one length-prefixed frame.  Each frame is one device
        append — atomic under the torn-tail discipline (a partial frame is
        discarded by replay), which is what makes the epoch commit a
        single atomic re-point of a slot."""
        blob = msgpack.packb(record, use_bin_type=True)
        self.device.append(SUPERBLOCK_FID,
                           len(blob).to_bytes(4, "little") + blob,
                           IOClass.MANIFEST)

    def _read_superblock(self) -> dict:
        if not self.device.exists(SUPERBLOCK_FID):
            raise RuntimeError("no superblock — device was never "
                               "initialised by a ShardedKVStore")
        with self.device.time_free():
            buf = self.device.read_all(SUPERBLOCK_FID, IOClass.MANIFEST)
        frames: List[dict] = []
        pos = 0
        while pos + 4 <= len(buf):
            ln = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            if pos + ln > len(buf):
                break                       # torn tail (mid-commit crash)
            frames.append(msgpack.unpackb(buf[pos:pos + ln], raw=False))
            pos += ln
        if not frames:
            raise RuntimeError("empty superblock")
        base = frames[0]
        n_shards = base["n_shards"]
        if "version" not in base:
            # v1 superblock (fixed crc32 % n routing era).  The default
            # slot map reproduces that placement only when n_shards
            # divides the slot count — refuse a silent misroute otherwise.
            if DEFAULT_SLOTS % n_shards != 0:
                raise RuntimeError(
                    f"cannot upgrade a v1 superblock with "
                    f"n_shards={n_shards}: slot routing matches the legacy "
                    f"crc32 % n placement only when n_shards divides "
                    f"{DEFAULT_SLOTS}")
            sb = {"n_shards": n_shards, "manifests": base["manifests"],
                  "n_slots": DEFAULT_SLOTS, "epoch": 0,
                  "slot_map": default_slot_map(n_shards, DEFAULT_SLOTS)}
        else:
            sb = {"n_shards": n_shards, "manifests": base["manifests"],
                  "n_slots": base["n_slots"], "epoch": base["epoch"],
                  "slot_map": list(base["slot_map"])}
        last_move: Optional[Tuple[int, Tuple[int, int, int]]] = None
        cleaned = -1
        intents: List[Tuple[int, int, int]] = []   # (slot, src, dst)

        def _drop_intent(slot: int, dst: int) -> None:
            for i, it in enumerate(intents):
                if it[0] == slot and it[2] == dst:
                    del intents[i]
                    return

        for fr in frames[1:]:
            if "mig_start" in fr:
                intents.append(tuple(fr["mig_start"]))
            if "mig_abort" in fr:
                _drop_intent(fr["mig_abort"][0], fr["mig_abort"][1])
            if "slot_map" in fr:
                sb["slot_map"] = list(fr["slot_map"])
                sb["epoch"] = fr["epoch"]
                if "move" in fr:
                    last_move = (fr["epoch"], tuple(fr["move"]))
                    _drop_intent(fr["move"][0], fr["move"][2])
            if "cleaned" in fr:
                cleaned = max(cleaned, fr["cleaned"])
        sb["pending_cleanup"] = (last_move[1]
                                 if last_move is not None
                                 and last_move[0] > cleaned else None)
        sb["pending_intents"] = intents
        return sb

    # ==================================================================
    # Routing
    # ==================================================================

    @contextmanager
    def _route_guard(self):
        """Hold the slot map still for the duration of one front-end op.

        Every op routes first and then executes through its shard, whose
        write/read path pumps the event heap — where a migration's epoch
        commit may be due.  Committing there would flip routing *between*
        the route decision and the record landing (the record would land
        on the former owner after the catch-up scan already ran: a silent
        lost write), or re-point slots halfway through a multi-shard
        scan.  While the guard is held, commits park on the rebalancer's
        deferred list; the outermost guard exit runs them — at which
        point the op's records are in the source memtable, so the commit
        catch-up copies them like any other pre-commit write.

        Concurrency: the guard is the *read* side of ``self.routing`` —
        shared across client threads, reentrant per thread.  An epoch
        commit needs the write side; inside ``pump`` it only ever
        ``try_acquire_write``s (any active reader defers it), and the
        reader whose release leaves the lock idle runs the deferred
        commits — the same semantics the old ``_route_locks`` counter
        gave a single thread."""
        self.routing.acquire_read()
        try:
            yield
        finally:
            if self.routing.release_read():
                self.rebalancer.run_deferred()

    def _slot(self, ukey: bytes) -> int:
        return slot_of(ukey, self.n_slots)

    def shard_of(self, ukey: bytes) -> int:
        return self.slot_map[slot_of(ukey, self.n_slots)]

    def shard_for(self, ukey: bytes) -> KVStore:
        return self.shards[self.shard_of(ukey)]

    def _tick_rebalance(self, n_ops: int = 1) -> None:
        with self._tick_mu:
            self._ops_since_rebalance += n_ops
            if self._ops_since_rebalance < REBALANCE_TICK_OPS:
                return
            self._ops_since_rebalance = 0
        self.rebalancer.run_deferred()
        self.rebalancer.maybe_rebalance()

    # ==================================================================
    # Single-op API (same surface as KVStore)
    # ==================================================================

    def put(self, ukey: bytes, value: bytes) -> None:
        with self._route_guard():
            slot = self._slot(ukey)
            self.rebalancer.note_put(slot, ukey, len(ukey) + len(value))
            self.rebalancer.note_route_put(slot, ukey)
            self.shards[self.slot_map[slot]].put(ukey, value)
        self._tick_rebalance()

    def delete(self, ukey: bytes) -> None:
        with self._route_guard():
            slot = self._slot(ukey)
            self.rebalancer.note_delete(slot, ukey)
            self.rebalancer.note_route_delete(slot, ukey)
            self.shards[self.slot_map[slot]].delete(ukey)
        self._tick_rebalance()

    def get(self, ukey: bytes, *,
            snapshot: Optional[Snapshot] = None) -> Optional[bytes]:
        if snapshot is not None:
            # Route by the snapshot's *captured* slot map: at capture time
            # the map's owner was authoritative for every version ≤ the
            # bound, and it retains them — migration cleanup tombstones
            # and any epoch flip happened after capture, so their seqs
            # exceed the shard's bound and are filtered out.  No
            # dual-routing, no routing guard needed.
            sid = snapshot.slot_map[self._slot(ukey)]
            return self.shards[sid].get(ukey, snapshot=snapshot)
        with self._route_guard():
            return self._get_routed(ukey, self.shard_of(ukey))

    def contains(self, ukey: bytes, *,
                 snapshot: Optional[Snapshot] = None) -> bool:
        """Presence check (tombstone-aware, no value I/O)."""
        if snapshot is not None:
            sid = snapshot.slot_map[self._slot(ukey)]
            return self.shards[sid].contains(ukey, snapshot=snapshot)
        with self._route_guard():
            sid = self.shard_of(ukey)
            src = self.shards[sid]
            slot = self._slot(ukey)
            dst_id = self.rebalancer.inflight.get(slot)
            if dst_id is None or dst_id == sid:
                return src.contains(ukey)
            if src.contains(ukey):
                return True
            present, _ = src.get_present(ukey)
            if present:            # tombstone on the authoritative source
                return False
            if self.rebalancer.is_window_deleted(slot, ukey):
                return False
            return self.shards[dst_id].contains(ukey)

    def _get_routed(self, ukey: bytes, sid: int) -> Optional[bytes]:
        """Point read with migration dual-routing: while a slot's move is
        in flight the *source* (current slot-map owner) stays
        authoritative — writes still land there — so its entry (including
        a tombstone) wins.  Only a key the source has never seen — and
        that was not deleted in the migration window (a bottom-level
        compaction can erase the tombstone without trace) — falls through
        to the target."""
        src = self.shards[sid]
        slot = self._slot(ukey)
        dst_id = self.rebalancer.inflight.get(slot)
        if dst_id is None or dst_id == sid:
            return src.get(ukey)
        present, val = src.get_present(ukey)
        if present:
            return val
        if self.rebalancer.is_window_deleted(slot, ukey):
            return None
        return self.shards[dst_id].get(ukey)

    # ==================================================================
    # Batched API
    # ==================================================================

    def write_batch(self, ops: Iterable[WriteOp]) -> None:
        """Apply a batch of ('put', k, v) / ('del', k) ops, grouped per
        shard, under one commit group: every op's WAL record queues in the
        shared GroupCommitLog and the batch is made durable by a single
        coalesced segment append — one device sync per batch instead of
        one per op.  Cross-shard reordering is safe — a key's ops stay on
        one shard in submission order — and grouping gives each shard one
        contiguous run of log records (locality a real batch write has).

        Ops are validated *before* the commit group opens: a malformed op
        rejects the whole batch with no record queued or applied, instead
        of failing mid-group with earlier records already committed."""
        ops = validate_batch_ops(ops)
        with self._route_guard():
            groups: List[List[WriteOp]] = [[] for _ in range(self.n_shards)]
            for op in ops:
                slot = self._slot(op[1])
                if op[0] == "put":
                    self.rebalancer.note_put(slot, op[1],
                                             len(op[1]) + len(op[2]))
                    self.rebalancer.note_route_put(slot, op[1])
                else:
                    self.rebalancer.note_delete(slot, op[1])
                    self.rebalancer.note_route_delete(slot, op[1])
                groups[self.slot_map[slot]].append(op)
            with self.commitlog.group():
                # Apply gate: snapshot capture serialises against the
                # whole multi-shard apply, so a bounds vector never
                # observes shard A post-batch but shard B pre-batch.
                with self._apply_gate:
                    for shard, group in zip(self.shards, groups):
                        for op in group:
                            if op[0] == "put":
                                shard.put(op[1], op[2])
                            else:
                                shard.delete(op[1])
        self._tick_rebalance(len(ops))

    def multi_get(self, keys: Sequence[bytes], *,
                  snapshot: Optional[Snapshot] = None
                  ) -> List[Optional[bytes]]:
        """Point-read a batch of keys; results align with ``keys``.
        Reads are grouped per shard so each shard serves its keys in one
        contiguous run (one event-pump per group, cache locality).

        The batch is **torn-read free**: with no explicit snapshot an
        implicit one is pinned for the call's duration, so a concurrent
        cross-shard ``write_batch`` is observed either entirely or not at
        all — never a partial batch."""
        if snapshot is None:
            with self.snapshot() as snap:
                return self.multi_get(keys, snapshot=snap)
        out: List[Optional[bytes]] = [None] * len(keys)
        groups: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            sid = snapshot.slot_map[self._slot(k)]
            groups.setdefault(sid, []).append(i)
        for sid, idxs in groups.items():
            shard = self.shards[sid]
            for i in idxs:
                out[i] = shard.get(keys[i], snapshot=snapshot)
        return out

    def scan(self, start: bytes, count: int, *,
             snapshot: Optional[Snapshot] = None
             ) -> List[Tuple[bytes, bytes]]:
        """Cross-shard merging scan over a snapshot (an implicit one is
        pinned when none is given, so the merged view can never tear a
        concurrent cross-shard batch).  Each shard contributes its
        ``count`` smallest keys ≥ start that route to it under the
        snapshot's *captured* slot map — in-flight migration copies on a
        target and pre-cleanup orphans on a former owner are filtered out
        at the index-entry level inside the shard scan, so junk never
        consumes the budget nor costs value reads.  A surviving key's
        owner shard therefore always lists it within its own top
        ``count``, the streams are pairwise disjoint (a key routes to
        exactly one shard), and a plain k-way merge of the first
        ``count`` keys is exact.  The captured map keeps the filter
        consistent shard to shard without holding the routing guard."""
        if snapshot is None:
            with self.snapshot() as snap:
                return self.scan(start, count, snapshot=snap)
        streams = [self._snapshot_scan(sid, start, count, snapshot)
                   for sid in range(self.n_shards)]
        merged = _heapq.merge(*streams, key=lambda kv: kv[0])
        out: List[Tuple[bytes, bytes]] = []
        for kv in merged:
            out.append(kv)
            if len(out) >= count:
                break
        return out

    def _snapshot_scan(self, sid: int, start: bytes, count: int,
                       snap: Snapshot) -> List[Tuple[bytes, bytes]]:
        """``count`` smallest keys ≥ start that route to shard ``sid``
        under the snapshot's captured slot map, as of its bounds."""
        return self.shards[sid].scan(
            start, count,
            accept=lambda k: snap.slot_map[slot_of(k, self.n_slots)] == sid,
            snapshot=snap)

    def _authoritative_scan(self, sid: int, start: bytes, count: int
                            ) -> List[Tuple[bytes, bytes]]:
        """``count`` smallest keys ≥ start that *currently route* to
        shard ``sid``, or every one it has if fewer remain.  The routing
        filter runs inside the shard scan on index entries, *before*
        value resolution — migration copies and orphans cost no value
        reads and never consume the result budget."""
        return self.shards[sid].scan(
            start, count,
            accept=lambda k: self.slot_map[slot_of(k, self.n_slots)] == sid)

    # ==================================================================
    # MVCC snapshots & read-modify-write
    # ==================================================================

    def snapshot(self) -> Snapshot:
        """Capture a cross-shard MVCC snapshot: one sequence bound per
        shard plus the current slot map, in-flight-migration view, epoch
        and global CSN — all under the routing guard, the apply gate and
        the engine lock, so the vector is a consistent cut:

        * the apply gate means no ``write_batch`` is mid-apply — a batch
          is visible on *every* shard or on none (batch atomicity);
        * the routing guard + engine lock mean the slot map, the
          rebalancer's in-flight view and the per-shard sequences belong
          to the same instant — no epoch flip can slide between them.

        The returned handle is a context manager; reads through it
        (``get``/``multi_get``/``scan``/``contains``) are repeatable until
        it closes.  While any snapshot is open, value GC is fully gated
        and compaction retains snapshot-visible versions (see
        ``core.mvcc``), so long-lived snapshots trade space for the
        frozen view — close them promptly."""
        with self._route_guard():
            with self._apply_gate:
                with self.sched_core.engine_lock:
                    bounds = [s.versions.seq for s in self.shards]
                    for s, b in zip(self.shards, bounds):
                        s.snapshots.register(b)
                    csn = self.commitlog.csn
                    self._snapshots_taken += 1
                    self._open_snapshots += 1
                epoch, slot_map, inflight = self.rebalancer.routing_view()
                snap = Snapshot(self, bounds, csn, slot_map=slot_map,
                                inflight=inflight, epoch=epoch)
        return snap

    def _release_snapshot(self, snap: Snapshot) -> None:
        with self.sched_core.engine_lock:
            for s, b in zip(self.shards, snap.bounds):
                s.snapshots.unregister(b)
                s._gc_check_pending = True
            self._open_snapshots -= 1

    def read_modify_write(self, ukey: bytes,
                          fn: Callable[[Optional[bytes]], Optional[bytes]],
                          max_retries: int = 64) -> Optional[bytes]:
        """Atomic read-modify-write (YCSB-F): read the key's current
        value, run ``fn`` on it *outside* any lock, then commit the new
        value only if the key is unchanged — otherwise retry with the
        fresh value.  ``fn`` returning ``None`` deletes the key; the
        return value is what was committed.

        The validation token is the (shard id, entry seq) pair observed by
        the read, compared under the owning shard's foreground latch
        inside a commit group — the same write path every other op uses,
        so the committed record is WAL-durable with the group's sync."""
        for _ in range(max_retries):
            with self._route_guard():
                sid = self.shard_of(ukey)
                shard = self.shards[sid]
                with shard._fg():
                    shard.sched.pump()
                    shard.stats_counters["gets"] += 1
                    e = shard.get_entry(ukey, IOClass.USER_READ)
                    token = (sid, e[1] if e is not None else 0)
                    cur = shard._resolve_value(e, IOClass.USER_READ)
            new = fn(cur)
            committed = False
            with self._route_guard():
                sid = self.shard_of(ukey)
                shard = self.shards[sid]
                slot = self._slot(ukey)
                with shard.sink.group():
                    with shard._fg():
                        e2 = shard.get_entry(ukey, IOClass.USER_READ)
                        token2 = (sid, e2[1] if e2 is not None else 0)
                        if token2 == token:
                            if new is None:
                                self.rebalancer.note_delete(slot, ukey)
                                self.rebalancer.note_route_delete(slot, ukey)
                                shard._write(ukey, VT_DELETE, b"")
                            else:
                                self.rebalancer.note_put(
                                    slot, ukey, len(ukey) + len(new))
                                self.rebalancer.note_route_put(slot, ukey)
                                shard._write(ukey, VT_VALUE, new)
                            shard.stats_counters["rmw_ops"] += 1
                            committed = True
                        else:
                            shard.stats_counters["rmw_conflicts"] += 1
            if committed:
                self._tick_rebalance()
                return new
        raise RuntimeError(
            f"read_modify_write: {max_retries} consecutive conflicts "
            f"on key {ukey!r}")

    def compare_and_swap(self, ukey: bytes, expected: Optional[bytes],
                         new: Optional[bytes]) -> bool:
        """Atomically write ``new`` iff the key's current value equals
        ``expected`` (``None`` = absent/deleted).  Returns whether the
        swap happened; validation and write share one latch hold."""
        with self._route_guard():
            sid = self.shard_of(ukey)
            shard = self.shards[sid]
            slot = self._slot(ukey)
            with shard.sink.group():
                with shard._fg():
                    shard.sched.pump()
                    shard.stats_counters["cas_ops"] += 1
                    shard.stats_counters["gets"] += 1
                    e = shard.get_entry(ukey, IOClass.USER_READ)
                    cur = shard._resolve_value(e, IOClass.USER_READ)
                    if cur != expected:
                        shard.stats_counters["cas_failures"] += 1
                        return False
                    if new is None:
                        self.rebalancer.note_delete(slot, ukey)
                        self.rebalancer.note_route_delete(slot, ukey)
                        shard._write(ukey, VT_DELETE, b"")
                    else:
                        self.rebalancer.note_put(
                            slot, ukey, len(ukey) + len(new))
                        self.rebalancer.note_route_put(slot, ukey)
                        shard._write(ukey, VT_VALUE, new)
        self._tick_rebalance()
        return True

    # ==================================================================
    # Lifecycle / background
    # ==================================================================

    def flush_all(self) -> None:
        for s in self.shards:
            with s._fg():
                if len(s.mem):
                    s._rotate_memtable()
                s.maybe_schedule_background()
        self.drain()

    def drain(self, max_sim_s: float = 1e9) -> None:
        """Quiesce every shard (single shared event heap)."""
        self.sched_core.drain(max_sim_s)

    # instrumentation hook fan-out (bench oracle support)
    @property
    def on_user_write(self) -> Optional[Callable[[bytes, int, bytes], None]]:
        return self._on_user_write

    @on_user_write.setter
    def on_user_write(self, fn: Optional[Callable[[bytes, int, bytes], None]]
                      ) -> None:
        self._on_user_write = fn
        for s in self.shards:
            s.on_user_write = fn

    # ==================================================================
    # Aggregated stats
    # ==================================================================

    def space_usage(self) -> Dict[str, object]:
        with self.sched_core.engine_lock:
            return self._space_usage_locked()

    def _space_usage_locked(self) -> Dict[str, object]:
        per = [s._space_usage_locked() for s in self.shards]
        lvl = [sum(p["index_level_bytes"][i] for p in per)
               for i in range(self.opts.num_levels)]
        tot_v = sum(p["value_total_bytes"] for p in per)
        live_v = sum(p["value_live_bytes"] for p in per)
        return {
            "total_bytes": self.device.total_bytes(),
            "index_bytes": sum(lvl),
            "index_level_bytes": lvl,
            "value_total_bytes": tot_v,
            "value_live_bytes": live_v,
            "value_file_bytes": sum(p["value_file_bytes"] for p in per),
            "s_index": _s_index(lvl),
            "exposed_ratio": (tot_v - live_v) / live_v if live_v > 0 else 0.0,
            "global_garbage_ratio": (tot_v - live_v) / tot_v
            if tot_v > 0 else 0.0,
            "per_shard": per,
        }

    def stats(self) -> Dict[str, object]:
        with self.sched_core.engine_lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, object]:
        counters: Dict[str, float] = {}
        gc_step: Dict[str, float] = {}
        for s in self.shards:
            for k, v in s.stats_counters.items():
                counters[k] = counters.get(k, 0) + v
            for k, v in s.gc_step_time.items():
                gc_step[k] = gc_step.get(k, 0.0) + v
        # A cross-shard snapshot registers one bound on every shard; count
        # it once at the front end (shards' own counters stay at their
        # solo-API value, normally 0 behind this front end).
        counters["snapshots"] = counters.get("snapshots", 0) \
            + self._snapshots_taken
        cache = self.cache.stats()
        # Placement: each shard runs its own engine over its own slice of
        # the key/size population, so tenants with different value-size
        # mixtures converge to *different* effective thresholds — report
        # the per-shard boundaries alongside the summed counters.
        per_pl = [s.placement.stats() for s in self.shards]
        placement: Dict[str, object] = {
            k: sum(p[k] for p in per_pl)
            for k in ("inline_records", "separated_records",
                      "migr_to_inline_keys", "migr_to_inline_bytes",
                      "migr_to_sep_keys", "migr_to_sep_bytes", "retunes")}
        placement["adaptive"] = bool(self.opts.adaptive_placement)
        placement["per_shard_threshold"] = [p["effective_threshold"]
                                            for p in per_pl]
        placement["effective_threshold"] = max(
            p["effective_threshold"] for p in per_pl)
        return {
            "sim_time_s": self.clock.now,
            "n_shards": self.n_shards,
            "space": self._space_usage_locked(),
            "io": self.device.stats.snapshot(),
            "counters": counters,
            "gc_step_time_s": gc_step,
            "cache_hit_ratio": cache["hit_ratio"],
            # Device-wide shared-cache view: quotas (sum exactly to the
            # budget), per-shard residency/hit/ghost-hit rates, read heat.
            "cache": cache,
            "max_gc_threads": self.sched_core.max_gc,
            "gc_bw_fraction": self.sched_core.gc_write_limiter.fraction,
            "wal": self.sched_core.wal_stats(),
            "bg_write_bytes": self.sched_core.bg_write_stats(),
            "rebalance": self.rebalancer.stats(),
            "mvcc": {"csn": self.commitlog.csn,
                     "active_snapshots": self._open_snapshots},
            "placement": placement,
            # Block I/O: one device-wide counter set (codec ratios, filter
            # probes, corruption) — shards share the device's instance.
            "blocks": self.device.block_stats.snapshot(),
            "per_shard_counters": [dict(s.stats_counters)
                                   for s in self.shards],
        }

    # -- observability (repro.obs) ---------------------------------------

    def metrics(self, *, sim_only: bool = False) -> Dict[str, object]:
        """Registry + amplification-ledger snapshot for the whole store
        (shards share the device's registry, so one call covers them),
        plus the device's per-class I/O totals and the shared cache's
        budget accounting — everything the invariant auditor cross-checks.
        ``sim_only`` drops wall-clock-derived series so two seeded runs
        compare equal."""
        with self.sched_core.engine_lock:
            snap: Dict[str, object] = {"sim_time_s": self.clock.now}
            snap["registry"] = self.obs.snapshot(sim_only=sim_only)
            snap["amp"] = self.obs.ledger.snapshot()
            snap["io"] = self.device.stats.snapshot()
            snap["cache"] = self.cache.stats()
            return snap

    def audit(self) -> "AuditReport":
        """Run the conservation-law auditor over a fresh metrics
        snapshot; ``.ok`` is False iff any invariant is violated."""
        return audit_snapshot(self.metrics())

    def start_trace(self, recorder: Optional[TraceRecorder] = None
                    ) -> TraceRecorder:
        if recorder is None:
            recorder = TraceRecorder(self.clock)
        with self.sched_core.engine_lock:
            self.device.tracer = recorder
            self.sched_core.tracer = recorder
        return recorder

    def stop_trace(self, path: Optional[str] = None
                   ) -> Optional[TraceRecorder]:
        with self.sched_core.engine_lock:
            recorder = self.device.tracer
            self.device.tracer = None
            self.sched_core.tracer = None
        if recorder is not None and path is not None:
            recorder.dump(path)
        return recorder

    @contextmanager
    def trace(self, path: Optional[str] = None):
        """``with db.trace("out.json"): ...`` — record and dump a trace."""
        recorder = self.start_trace()
        try:
            yield recorder
        finally:
            self.stop_trace(path)

    def _trace_cache_retune(self, quotas: List[int]) -> None:
        tracer = self.sched_core.tracer
        if tracer is not None:
            tracer.instant("cache", "quota_retune",
                           args={"quotas": quotas})


def _s_index(level_sizes: List[int]) -> float:
    """Space amplification of the merged index tree (paper eq. 1 shape,
    same formula as VersionSet.s_index over summed level sizes)."""
    nonempty = [i for i, s in enumerate(level_sizes) if s > 0]
    if not nonempty:
        return 1.0
    last = nonempty[-1]
    k_l = level_sizes[last]
    k_u = sum(level_sizes[:last])
    return (k_u + k_l) / k_l if k_l else 1.0
