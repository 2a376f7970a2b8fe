"""The key-value store facade.

``KVStore(preset('scavenger_plus'))`` gives the paper's full system;
``preset('rocksdb') / 'blobdb' / 'titan' / 'terarkdb'`` give the evaluated
baselines; the ablation presets give the Fig. 19/20 ladder.

Execution model: a discrete-event simulation over simulated time (see
``scheduler.py``) — user operations advance the clock with foreground
costs, background jobs occupy lanes, effects apply when their lane
completes, and write stalls advance the clock to the next completion.
"""

from __future__ import annotations

import heapq as _heapq
import threading
from bisect import bisect_left
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from ..obs import AuditReport, TraceRecorder, audit_snapshot
from ..store.blockio import BlockCorruptionError
from ..store.device import BlockDevice, Clock, CostModel, IOClass
from ..store.format import (VT_DELETE, VT_INDEX_KA, VT_INDEX_KF, VT_VALUE,
                            decode_ka, decode_kf, encode_ka, encode_kf,
                            entry_value_size)
from ..store.memtable import WAL, Memtable
from ..store.tables import (Entry, KTableReader, KTableWriter, LogTableReader,
                            LogTableWriter, RTableReader, RTableWriter,
                            VBTableReader, VBTableWriter)
from .cache import ShardCacheHandle, SharedReadCache
from .commitlog import (GroupCommitLog, MemtableLog, SharedCommitSink,
                        SoloCommitSink)
from .compaction import execute_compaction, plan_compaction
from .gc import pick_gc_candidate, run_gc_terark, run_gc_titan
from .mvcc import Snapshot, SnapshotRegistry
from .options import Options
from .placement import PlacementEngine
from .scheduler import (JOB_COMPACTION, JOB_FLUSH, JOB_GC, Scheduler,
                        SchedulerCore)
from .version import FileMeta, VersionSet, VSSTMeta

GC_STEP_CLASSES = (IOClass.GC_READ, IOClass.GC_LOOKUP, IOClass.GC_WRITE,
                   IOClass.GC_WRITE_INDEX)


def validate_batch_ops(ops) -> list:
    """Materialize and validate a write_batch op list *before* any commit
    group opens: a malformed op — wrong kind, wrong arity, or a
    non-bytes key/value that would blow up inside the WAL encoder —
    rejects the whole batch with nothing queued, applied, or accounted
    (shared by KVStore and ShardedKVStore)."""
    ops = list(ops)
    for op in ops:
        if not isinstance(op, (tuple, list)) or not op \
                or op[0] not in ("put", "del") \
                or len(op) != (3 if op[0] == "put" else 2) \
                or not isinstance(op[1], (bytes, bytearray)) \
                or (op[0] == "put"
                    and not isinstance(op[2], (bytes, bytearray))):
            raise ValueError(f"bad batch op {op!r}")
    return ops


class KVStore:
    def __init__(self, opts: Options, device: Optional[BlockDevice] = None,
                 recover: bool = False,
                 sched_core: Optional[SchedulerCore] = None,
                 manifest_fid: int = 1,
                 commit_log: Optional[GroupCommitLog] = None,
                 shard_tag: int = 0,
                 cache: Optional[ShardCacheHandle] = None) -> None:
        self.opts = opts.validate()
        self.device = device or BlockDevice(Clock(), CostModel())
        self.clock = self.device.clock
        # Block cache: a shard of a ShardedKVStore is handed its view of
        # the one device-wide SharedReadCache; a standalone store owns a
        # private single-shard core (ghost admission still applies when
        # opts.shared_cache is on).
        self.cache = cache if cache is not None \
            else SharedReadCache.from_options(opts).handle(0)
        # Per-shard foreground latch (level 1 of the lock hierarchy, see
        # core.concurrency): serializes client threads on this store's
        # memtable/sink state.  Reentrant so write_batch can hold it
        # across its per-op calls.
        self.latch = threading.RLock()
        if recover:
            # Crash restart: the manifest of a standalone store is always
            # fid 1 (first file created); a shard inside a ShardedKVStore
            # is handed its manifest fid from the superblock.  Replay it,
            # then the last WAL (torn tail tolerated).  The time_free
            # window keeps replay I/O off the simulated clock and is
            # exception-safe (a corrupt manifest cannot leave time
            # charging disabled).
            with self.device.time_free():
                self.versions = VersionSet(self.device, opts.num_levels,
                                           manifest_fid=manifest_fid)
                self.versions.recover()
        else:
            self.versions = VersionSet(self.device, opts.num_levels)
        self.sched = Scheduler(self.clock, self.device, opts,
                               core=sched_core)
        # Re-offer admission on every job completion: a freed lane may be
        # the one this store's pending background work is waiting for.
        self.sched.core.add_waiter(self.maybe_schedule_background)
        # Placement policy: owns the HeatSketch (ex-DropCache) shared by
        # hot/cold vSST splitting and the adaptive separate-vs-inline
        # boundary; a no-op stand-in for the static threshold when
        # opts.adaptive_placement is off.
        self.placement = PlacementEngine(opts)
        # Read-aware placement: the engine drains the cache's
        # per-size-class read-heat counters at each retune.
        self.placement.read_heat_source = self.cache
        # Physical-encoding-aware placement: measured compression ratios
        # and the vSST wasted-probe rate feed the cost model's space/read
        # terms (the device's counters — shared across a sharded store).
        self.placement.blockio_source = self.device.block_stats
        # Files whose blocks failed checksum verification: dropped from
        # the reader/cache pool, never probed again.  The file's bytes are
        # kept on the device for forensics (unlike drop_table).
        self.quarantined: Set[int] = set()
        self.shard_tag = shard_tag
        # MVCC: registered snapshot bounds for THIS shard.  The memtable's
        # retain hook keeps a shadowed version alive exactly while a
        # registered bound can still read it; compaction and GC consult
        # the same registry (see core.mvcc).
        self.snapshots = SnapshotRegistry()
        self.mem = Memtable(retain=self.snapshots.needs_version)
        if recover and commit_log is None:
            # Replay every WAL logged since the last completed flush,
            # in order (earlier seqs overwritten by later ones).  Replay
            # I/O is off the clock; exception-safe via time_free.
            with self.device.time_free():
                for wal_fid in list(self.versions.pending_wals):
                    if not self.device.exists(wal_fid):
                        continue
                    for ukey, seq, vtype, payload in WAL.replay(self.device,
                                                                wal_fid):
                        self.mem.put(ukey, seq, vtype, payload)
                        self.versions.seq = max(self.versions.seq, seq)
                    self.device.delete(wal_fid)
                self.versions.pending_wals.clear()
        # else (recover with a shared commit_log): pending segments
        # interleave records from every shard — the owning ShardedKVStore
        # replays them once, routing records by shard tag, then clears
        # the pending lists.
        # Commit sink: solo stores keep per-memtable WAL files with one
        # append per record; shards of a sharded store write framed,
        # shard-tagged records through one shared GroupCommitLog.
        if commit_log is not None:
            self.sink = SharedCommitSink(commit_log, shard_tag)
        else:
            self.sink = SoloCommitSink(self.device, core=self.sched.core)
        self.sink.on_open = self._note_wal_open
        self.sink.start()
        if recover and commit_log is None:
            # Solo WAL files carry no CSN stamps; the manifest floor is
            # the best restart point (sharded recovery additionally takes
            # the max over segment stamps — see ShardedKVStore).
            self.sink.csn = max(self.sink.csn, self.versions.csn)
        self.immutables: List[Tuple[Memtable, MemtableLog]] = []
        self._readers: Dict[int, object] = {}
        # Observability: counters are registry groups on the shared
        # device (plain dicts at runtime — the hot-path ``+=`` is
        # unchanged — but named, snapshot-able, and monotonic across a
        # crash/recovery cycle that reuses the device).  stall_time_s
        # stays the aggregate; the stall_*_s keys attribute it by cause
        # (admission stalls split from write-controller slowdowns,
        # which in turn are distinct from the wall-clock commit-pipeline
        # waits counted in "wall/commit_pipeline").
        self.obs = self.device.metrics
        self.stats_counters: Dict[str, float] = self.obs.counters(
            f"shard{shard_tag}/counters", {
                "puts": 0, "gets": 0, "deletes": 0, "scans": 0, "flushes": 0,
                "compactions": 0, "gc_runs": 0, "stall_time_s": 0.0,
                "stall_memtable_s": 0.0, "stall_l0_s": 0.0,
                "stall_space_s": 0.0, "slowdown_time_s": 0.0,
                "forced_gc": 0, "cap_breaches": 0,
                "snapshots": 0, "rmw_ops": 0, "rmw_conflicts": 0,
                "cas_ops": 0, "cas_failures": 0,
            })
        self.gc_step_time: Dict[str, float] = self.obs.counters(
            f"shard{shard_tag}/gc_step_time",
            {c.value: 0.0 for c in GC_STEP_CLASSES})
        if opts.obs_sampling:
            self.obs.sampling = True
        # Causal tracing rides the same sampling gate: sampled ops get an
        # OpContext that decomposes their latency into named shares and
        # records an exemplar with the causal chain (commit round,
        # blocking job, device hops) on the latency histogram bucket.
        self.obs.causal.sample_every = opts.obs_sample_every
        self.cache.core.causal = self.obs.causal
        self._lat = {op: self.obs.histogram(f"shard{shard_tag}/latency/{op}")
                     for op in ("put", "get", "delete", "scan")}
        # Amplification ledger: this store contributes its version-set
        # space components and its foreground logical bytes; re-attach
        # under the same tag after recovery replaces the stale store.
        self.obs.ledger.attach(shard_tag, self)
        self.placement.on_retune = self._trace_retune
        self._ops_since_sched = 0
        self._gc_check_pending = False
        # optional instrumentation hook: called with (ukey, vtype, payload)
        # on every user write — used by the bench oracle for true-garbage
        # (hidden vs exposed) measurement.
        self.on_user_write: Optional[Callable[[bytes, int, bytes], None]] = None

    # ==================================================================
    # Write path
    # ==================================================================

    @contextmanager
    def _fg(self):
        """One foreground op's lock span: shard latch (level 1), then the
        engine lock (level 2) for the op's whole clock/IO/state mutation.
        Never acquire the latch while holding the engine lock (background
        job bodies and event effects run engine-only for exactly that
        reason — see write_index_entry)."""
        with self.latch:
            with self.sched.core.engine_lock:
                yield

    def put(self, ukey: bytes, value: bytes) -> None:
        with self._fg():
            t0 = self.clock.now if self.obs.sampling else None
            ctx = (self.obs.causal.start("put", self.shard_tag)
                   if t0 is not None else None)
            self._write(ukey, VT_VALUE, value)
            self.stats_counters["puts"] += 1
            if t0 is not None:
                lat = self.clock.now - t0
                self._lat["put"].record(lat)
                if ctx is not None:
                    self._finish_ctx(ctx, "put", lat, t0)

    def delete(self, ukey: bytes) -> None:
        with self._fg():
            t0 = self.clock.now if self.obs.sampling else None
            ctx = (self.obs.causal.start("delete", self.shard_tag)
                   if t0 is not None else None)
            self._write(ukey, VT_DELETE, b"")
            self.stats_counters["deletes"] += 1
            if t0 is not None:
                lat = self.clock.now - t0
                self._lat["delete"].record(lat)
                if ctx is not None:
                    self._finish_ctx(ctx, "delete", lat, t0)

    def _in_commit_group(self) -> bool:
        """Is the calling thread inside an open commit group on this
        store's sink?  Sampled writes finishing in-group defer their
        exemplar until the group's WAL round publishes, so the record can
        carry the round's CSN and the op's leader/follower role."""
        log = getattr(self.sink, "log", None)
        return (log if log is not None else self.sink).in_group

    def _finish_ctx(self, ctx, op: str, lat: float, t0: float) -> None:
        """Close a sampled op's causal context: attribute the residual,
        store (or park, when still inside a commit group) the exemplar on
        the op's latency-histogram bucket, and emit the request-track
        span the flow arrows terminate on."""
        self.obs.causal.finish(
            ctx, self._lat[op].name, lat,
            defer=self._in_commit_group(),
            tracer=self.sched.core.tracer, t0=t0)

    def write_batch(self, ops) -> None:
        """Apply ('put', k, v) / ('del', k) ops under one commit group on
        the store's private sink: records queue and the commit leader
        drains them with a single coalesced WAL append — one sync per
        batch instead of one per record, the solo-store counterpart of the
        sharded cross-shard group commit (visible in ``stats()["wal"]``).

        Ops are validated *before* the group opens so a malformed batch
        is rejected whole, with nothing queued or applied.

        Lock shape: the group is the *outermost* frame — the latch is
        released before group exit, which may block on the commit
        condition, so concurrent batches on other threads can apply to
        the memtable (taking the latch and per-op engine sections) while
        this one waits for the leader: that is the pipelining overlap,
        and it is also why a thread never waits on the commit condition
        holding the latch or the engine lock (the commit leader needs
        the engine lock to drain)."""
        ops = validate_batch_ops(ops)
        with self.sink.group():
            with self.latch:
                for op in ops:
                    if op[0] == "put":
                        self.put(op[1], op[2])
                    else:
                        self.delete(op[1])

    def multi_get(self, keys, *, snapshot: Optional[Snapshot] = None
                  ) -> List[Optional[bytes]]:
        """Point-read a batch of keys; results align with ``keys``.
        Batch-atomic even without a snapshot: the latch is held across
        all per-key gets (reentrantly), and ``write_batch`` holds it
        across its whole apply — so a standalone multi_get can never
        straddle half of a concurrent batch."""
        with self.latch:
            return [self.get(k, snapshot=snapshot) for k in keys]

    def _note_wal_open(self, fid: int) -> None:
        """The active memtable gained a dependency on log file ``fid`` —
        record it in the manifest so recovery knows to replay it (the
        same edit manifest replay applies, so live and recovered
        pending-WAL state cannot diverge)."""
        self.versions.apply_edit({"wal": fid, "seq": self.versions.seq,
                                  "csn": getattr(self.sink, "csn", 0)})

    def _write(self, ukey: bytes, vtype: int, payload: bytes) -> None:
        self.sched.pump()
        self._maybe_stall()
        if self.opts.adaptive_placement:
            # Placement signals, pre-insert: the size population (every
            # value write) and the lifetime signal (overwriting a version
            # still in the memtable is a drop compaction will never see —
            # a flushed older version is observed there instead, so each
            # shadowed version is counted exactly once).
            old = self.mem.get(ukey)
            if old is not None and old[1] != VT_DELETE:
                self.placement.observe_drop(ukey,
                                            entry_value_size(old[1], old[2]))
            if vtype == VT_VALUE:
                self.placement.observe_write(ukey, len(payload))
        self.versions.seq += 1
        self.sink.append(ukey, self.versions.seq, vtype, payload)
        self.mem.put(ukey, self.versions.seq, vtype, payload)
        self.device.charge_cpu()
        # Amplification-ledger denominator: logical user bytes.
        led = self.obs.ledger
        led.user_bytes += len(ukey) + len(payload)
        led.user_ops += 1
        if self.on_user_write is not None:
            self.on_user_write(ukey, vtype, payload)
        if self.mem.approx_bytes >= self.opts.memtable_bytes:
            self._rotate_memtable()
        self._ops_since_sched += 1
        if self._ops_since_sched >= 64:
            self._ops_since_sched = 0
            self.maybe_schedule_background()
            self.sched.govern_bandwidth()

    def write_index_entry(self, ukey: bytes, vtype: int, payload: bytes,
                          cls: IOClass) -> None:
        """Internal write used by Titan-style GC Write-Index (and the
        migration catch-up copy).  Engine lock only — callers are job
        bodies or event effects already inside the engine section, and
        taking the shard latch here would invert the latch -> engine
        order a foreground op on this shard may hold."""
        with self.sched.core.engine_lock:
            self.versions.seq += 1
            self.sink.append(ukey, self.versions.seq, vtype, payload, cls)
            self.mem.put(ukey, self.versions.seq, vtype, payload)
            if self.mem.approx_bytes >= self.opts.memtable_bytes:
                self._rotate_memtable()

    def _rotate_memtable(self) -> None:
        handle = self.sink.rotate()
        self.immutables.append((self.mem, handle))
        self.mem = Memtable(retain=self.snapshots.needs_version)
        self.maybe_schedule_background()

    # -- stalls ----------------------------------------------------------
    def _stall_reason(self) -> Optional[str]:
        if len(self.immutables) > 2:
            return "memtable"
        l0 = len(self.versions.levels[0])
        if l0 >= self.opts.l0_stop:
            return "l0"
        cap = self.opts.space_cap_bytes
        if cap is not None and self.device.total_bytes() >= cap:
            return "space"
        return None

    def _maybe_stall(self) -> None:
        causal = self.obs.causal
        # slowdown band first (RocksDB-style soft delay)
        if len(self.versions.levels[0]) >= self.opts.l0_slowdown:
            self.clock.advance(100e-6)
            self.stats_counters["slowdown_time_s"] += 100e-6
            causal.charge_named("slowdown", 100e-6)
        guard = 0
        core = self.sched.core
        while True:
            reason = self._stall_reason()
            if reason is None:
                return
            self.maybe_schedule_background(stalled_for=reason)
            t0 = self.clock.now
            # Whatever job completes during the wait is the stall's
            # proximate cause — clear the marker so a completion from a
            # previous wait can't be mis-blamed.
            core.last_completed = None
            # The whole wait is one stall share: absorb mode swallows the
            # per-I/O charges of the effects pumped inside it (they would
            # double-count against the stall_<reason> share below).
            with causal.absorb():
                relieved = self.sched.wait_for_event()
            if not relieved:
                # Nothing in flight can relieve the stall (e.g. cap set
                # below working-set size) — record the breach and proceed
                # so workloads terminate.
                self.stats_counters["cap_breaches"] += 1
                return
            dt = self.clock.now - t0
            self.stats_counters["stall_time_s"] += dt
            # Attribute the admission stall to its cause (distinct from
            # the soft write-controller slowdown counted above).
            self.stats_counters[f"stall_{reason}_s"] += dt
            blk = core.last_completed
            causal.charge_stall(reason, dt,
                                by_kind=blk[0] if blk else None,
                                by_job=blk[1] if blk else None)
            tracer = core.tracer
            if tracer is not None and dt > 0.0:
                args = {"reason": reason}
                if blk is not None:
                    args["behind"] = f"{blk[0]} #{blk[1]}"
                tracer.complete(f"fg/shard{self.shard_tag}", "stall",
                                t0, dt, args)
                if blk is not None and causal.current() is not None:
                    # Causal flow arrow: blocking job's lane -> the
                    # sampled op's request track.
                    fid = tracer.next_flow_id()
                    tracer.flow_start(blk[2], "blocked_by", blk[3], fid,
                                      {"kind": blk[0], "job": blk[1]})
                    tracer.flow_end(f"op/shard{self.shard_tag}",
                                    "blocked_by", self.clock.now, fid,
                                    {"reason": reason})
            guard += 1
            if guard > 100000:
                raise RuntimeError("stall livelock")

    # ==================================================================
    # Read path
    # ==================================================================

    def mem_lookup(self, ukey: bytes, bound: Optional[int] = None
                   ) -> Optional[Tuple[int, int, bytes]]:
        if bound is None:
            v = self.mem.get(ukey)
            if v is not None:
                return v
            for m, _ in reversed(self.immutables):
                v = m.get(ukey)
                if v is not None:
                    return v
            return None
        v = self.mem.get_at(ukey, bound)
        if v is not None:
            return v
        for m, _ in reversed(self.immutables):
            v = m.get_at(ukey, bound)
            if v is not None:
                return v
        return None

    def get_entry(self, ukey: bytes, cls: IOClass,
                  max_seq: Optional[int] = None) -> Optional[Entry]:
        """Index-LSM point lookup: memtable → immutables → L0 → L1+.

        With ``max_seq`` (a snapshot bound), each source yields its newest
        version with ``seq <= max_seq``; a key's versions are distributed
        monotonically across the sources (flush order), so the FIRST
        source holding any visible version holds the newest visible one.

        GC passes GC_LOOKUP here — on DTables the probe touches only
        high-priority index-entry blocks (paper III-B.2)."""
        self.device.charge_cpu()
        v = self.mem_lookup(ukey, max_seq)
        if v is not None:
            seq, vtype, payload = v
            return (ukey, seq, vtype, payload)
        use_idx_probe = cls == IOClass.GC_LOOKUP
        for f in self.versions.levels[0]:           # newest first
            if f.smallest <= ukey <= f.largest:
                try:
                    r = self.reader(f.fid, cls)
                    e = (r.get_index_entry(ukey, cls) if use_idx_probe
                         else r.get(ukey, cls, max_seq))
                except BlockCorruptionError:
                    # kSSTs have no redundant copy; skipping the file
                    # could surface a STALE older version from a deeper
                    # level — fail loudly rather than serve wrong data.
                    self._quarantine(f.fid)
                    raise
                if e is not None:
                    return e
        for level in range(1, self.versions.num_levels):
            files = self.versions.levels[level]
            if not files:
                continue
            smallests = [f.smallest for f in files]
            i = bisect_left(smallests, ukey)
            # Probe every file containing the key.  The level invariant
            # normally yields exactly one, but in-flight compaction
            # effects can leave a short-lived overlap — take max seq.
            cands = []
            if i < len(files) and files[i].smallest == ukey:
                cands.append(files[i])
            j = i - 1
            while j >= 0 and files[j].largest >= ukey:
                if files[j].smallest <= ukey:
                    cands.append(files[j])
                j -= 1
            best: Optional[Entry] = None
            for cand in cands:
                try:
                    r = self.reader(cand.fid, cls)
                    e = (r.get_index_entry(ukey, cls) if use_idx_probe
                         else r.get(ukey, cls, max_seq))
                except BlockCorruptionError:
                    self._quarantine(cand.fid)
                    raise
                if e is not None and (best is None or e[1] > best[1]):
                    best = e
            if best is not None:
                return best
        return None

    def _snap_bound(self, snapshot: Optional[Snapshot]) -> Optional[int]:
        return None if snapshot is None else snapshot.bounds[self.shard_tag]

    def get(self, ukey: bytes, *,
            snapshot: Optional[Snapshot] = None) -> Optional[bytes]:
        """Point read; ``snapshot`` pins it to the snapshot's bound for
        this shard (the newest version with ``seq <= bound``)."""
        return self.get_present(ukey, snapshot=snapshot)[1]

    def contains(self, ukey: bytes, *,
                 snapshot: Optional[Snapshot] = None) -> bool:
        """Presence check: does ``ukey`` have a live (non-tombstone)
        version — under ``snapshot`` if given?  Cheaper than ``get`` for
        separated values: the index entry decides, no value hop."""
        with self._fg():
            self.sched.pump()
            self.stats_counters["gets"] += 1
            t0 = self.clock.now if self.obs.sampling else None
            ctx = (self.obs.causal.start("get", self.shard_tag)
                   if t0 is not None else None)
            e = self.get_entry(ukey, IOClass.USER_READ,
                               self._snap_bound(snapshot))
            if t0 is not None:
                lat = self.clock.now - t0
                self._lat["get"].record(lat)
                if ctx is not None:
                    self._finish_ctx(ctx, "get", lat, t0)
            return e is not None and e[2] != VT_DELETE

    def get_present(self, ukey: bytes, *,
                    snapshot: Optional[Snapshot] = None
                    ) -> Tuple[bool, Optional[bytes]]:
        """Point read that distinguishes *no entry anywhere* ``(False,
        None)`` from a present entry ``(True, value)`` — a tombstone is
        present with value ``None``.  The sharded front-end uses the
        presence bit to dual-route reads during a slot migration (a
        source tombstone must win over a stale copy on the target).

        DEPRECATED as public API: use ``get(key, snapshot=...)`` for
        values and ``contains`` for presence; this shim remains for the
        rebalancer's dual-routing internals."""
        with self._fg():
            self.sched.pump()
            self.stats_counters["gets"] += 1
            t0 = self.clock.now if self.obs.sampling else None
            ctx = (self.obs.causal.start("get", self.shard_tag)
                   if t0 is not None else None)
            e = self.get_entry(ukey, IOClass.USER_READ,
                               self._snap_bound(snapshot))
            out = ((False, None) if e is None
                   else (True, self._resolve_value(e, IOClass.USER_READ)))
            if t0 is not None:
                lat = self.clock.now - t0
                self._lat["get"].record(lat)
                if ctx is not None:
                    self._finish_ctx(ctx, "get", lat, t0)
            return out

    # -- MVCC snapshots + conditional writes -----------------------------

    def snapshot(self) -> Snapshot:
        """Pin a consistent read view at the current applied sequence.
        The latch serializes capture against ``write_batch`` (which holds
        it across the whole batch), so a batch is never half-visible."""
        with self._fg():
            bound = self.versions.seq
            self.snapshots.register(bound)
            self.stats_counters["snapshots"] += 1
            csn = getattr(self.sink, "csn", 0)
        bounds = [0] * (self.shard_tag + 1)
        bounds[self.shard_tag] = bound
        return Snapshot(self, bounds, csn)

    def _release_snapshot(self, snap: Snapshot) -> None:
        with self.sched.core.engine_lock:
            self.snapshots.unregister(snap.bounds[self.shard_tag])
            # Anything GC skipped while this bound was registered is
            # re-evaluated at the next scheduling tick.
            self._gc_check_pending = True

    def read_modify_write(self, ukey: bytes,
                          fn: Callable[[Optional[bytes]], Optional[bytes]],
                          max_retries: int = 64) -> Optional[bytes]:
        """Atomic read-modify-write: read the current value, apply ``fn``
        outside any lock, then commit the result only if the key's newest
        sequence is unchanged — else retry with the fresh value (optimistic
        concurrency; conflicts counted in ``stats()["counters"]``).
        ``fn`` returning ``None`` deletes the key.  The validated write
        rides the commit pipeline like any batch record."""
        for _ in range(max_retries):
            with self._fg():
                self.sched.pump()
                self.stats_counters["gets"] += 1
                e = self.get_entry(ukey, IOClass.USER_READ)
                token = e[1] if e is not None else 0
                cur = self._resolve_value(e, IOClass.USER_READ)
            new = fn(cur)
            with self.sink.group():
                with self._fg():
                    e2 = self.get_entry(ukey, IOClass.USER_READ)
                    if (e2[1] if e2 is not None else 0) != token:
                        self.stats_counters["rmw_conflicts"] += 1
                        continue
                    if new is None:
                        self._write(ukey, VT_DELETE, b"")
                    else:
                        self._write(ukey, VT_VALUE, new)
                    self.stats_counters["rmw_ops"] += 1
                    return new
        raise RuntimeError(f"read_modify_write: {max_retries} consecutive "
                           f"conflicts on {ukey!r}")

    def compare_and_swap(self, ukey: bytes, expected: Optional[bytes],
                         new: Optional[bytes]) -> bool:
        """Write ``new`` iff the key's current value equals ``expected``
        (``None`` = absent/deleted on either side).  Single attempt; the
        compare and the write share one foreground lock span."""
        with self.sink.group():
            with self._fg():
                self.sched.pump()
                self.stats_counters["cas_ops"] += 1
                e = self.get_entry(ukey, IOClass.USER_READ)
                cur = self._resolve_value(e, IOClass.USER_READ)
                if cur != expected:
                    self.stats_counters["cas_failures"] += 1
                    return False
                if new is None:
                    self._write(ukey, VT_DELETE, b"")
                else:
                    self._write(ukey, VT_VALUE, new)
                return True

    def _resolve_value(self, e: Optional[Entry], cls: IOClass
                       ) -> Optional[bytes]:
        """Resolve an index entry to its value.  Foreground resolutions
        (USER_READ) feed the cache's per-size-class read-heat counters:
        an inline value pays no second hop (and would pay one if it were
        separated — ``absorbed=False`` is the honest counterfactual,
        since its bytes are not in the value-block cache today); a
        separated value's hop is *absorbed* when the value block came
        out of the cache instead of the device."""
        if e is None:
            return None
        _, _, vtype, payload = e
        if vtype == VT_DELETE:
            return None
        if vtype == VT_VALUE:
            if cls == IOClass.USER_READ:
                self.cache.note_value_read(len(payload), absorbed=False)
            return payload
        if vtype == VT_INDEX_KA:
            fid, off, ln = decode_ka(payload)
            if not self.device.exists(fid):
                return None
            val = self.log_reader(fid).read_record(off, ln, cls)[1]
            if cls == IOClass.USER_READ:
                # value logs are read straight off the device, uncached
                self.cache.note_value_read(len(val), absorbed=False)
            return val
        # KF: probe the lookup-group candidates (primary first).  A
        # candidate whose block fails its checksum is quarantined and the
        # NEXT candidate — GC's not-yet-dropped rewrite of the same group,
        # when one exists — serves as the redundant copy; only when no
        # candidate can serve does the corruption surface to the caller.
        fid, _ = decode_kf(payload)
        corrupt: Optional[BlockCorruptionError] = None
        for cand in self.versions.lookup_candidates(fid):
            meta = self.versions.vssts.get(cand)
            if meta is None or not self.device.exists(cand):
                continue
            rr = (self.r_reader(cand) if meta.fmt == "rtable"
                  else self.vb_reader(cand))
            # Absorbed = the cache satisfied the hop: no new USER_READ
            # device op during the probe (uniform across RTable record
            # cache and VBTable block cache).
            ops0 = self.device.stats.by_class[cls].ops
            try:
                val = rr.get(e[0], cls)
            except BlockCorruptionError as exc:
                self._quarantine(cand)
                corrupt = exc
                continue
            if val is not None:
                if cls == IOClass.USER_READ:
                    self.cache.note_value_read(
                        len(val),
                        absorbed=self.device.stats.by_class[cls].ops == ops0)
                return val
        if corrupt is not None:
            raise corrupt
        return None

    def entry_streams(self, start: bytes,
                      cls: IOClass = IOClass.USER_READ,
                      bound: Optional[int] = None) -> List[Iterator[Entry]]:
        """The store's merged-iteration sources from ``start``: active +
        immutable memtables, each L0 file, and one chained stream per
        deeper level — every stream sorted by (key asc, seq desc).
        Shared by the user scan and the migration slot copy (which reads
        with the GC I/O class), so level-iteration semantics cannot
        diverge between the two.  ``bound`` (a snapshot's seq bound for
        this shard) filters every stream to ``seq <= bound`` *before* the
        caller's newest-wins dedup, and includes the memtables' retained
        version history."""
        streams: List[Iterator[Entry]] = []

        def mem_stream(m: Memtable) -> Iterator[Entry]:
            it = m.sorted_items() if bound is None else m.sorted_entries()
            for k, (seq, vt, pl) in it:
                if k >= start and (bound is None or seq <= bound):
                    yield (k, seq, vt, pl)

        def bounded(it: Iterator[Entry]) -> Iterator[Entry]:
            if bound is None:
                return it
            return (e for e in it if e[1] <= bound)

        streams.append(mem_stream(self.mem))
        for m, _ in self.immutables:
            streams.append(mem_stream(m))
        for f in self.versions.levels[0]:
            if f.largest >= start:
                streams.append(bounded(self.reader(f.fid, cls)
                                       .iter_from(start, cls)))
        for level in range(1, self.versions.num_levels):
            files = [f for f in self.versions.levels[level]
                     if f.largest >= start]
            if files:
                streams.append(bounded(self._level_stream(files, start,
                                                          cls)))
        return streams

    def scan(self, start: bytes, count: int,
             accept: Optional[Callable[[bytes], bool]] = None,
             *, snapshot: Optional[Snapshot] = None
             ) -> List[Tuple[bytes, bytes]]:
        """Range scan: merged iteration over memtables and all levels,
        resolving separated values through the value store.  ``accept``
        filters *keys* before their value is resolved — the sharded
        front-end passes a routing filter here so migration copies and
        orphans neither cost value reads nor consume the budget.
        ``snapshot`` pins the scan to its seq bound for this shard."""
        with self._fg():
            self.sched.pump()
            self.stats_counters["scans"] += 1
            t0 = self.clock.now if self.obs.sampling else None
            ctx = (self.obs.causal.start("scan", self.shard_tag)
                   if t0 is not None else None)
            out: List[Tuple[bytes, bytes]] = []
            prev: Optional[bytes] = None
            # Scan-window admission: blocks touched only by this sweep
            # neither evict the point-read working set nor pollute the
            # ghost (hits still count, so hot overlap still scores).
            with self.cache.scan_window():
                for e in _heapq.merge(*self.entry_streams(
                                          start, IOClass.USER_READ,
                                          self._snap_bound(snapshot)),
                                      key=lambda e: (e[0], -e[1])):
                    if e[0] == prev:
                        continue
                    prev = e[0]
                    if accept is not None and not accept(e[0]):
                        continue
                    val = self._resolve_value(e, IOClass.USER_READ)
                    if val is None:
                        continue
                    out.append((e[0], val))
                    if len(out) >= count:
                        break
            if t0 is not None:
                lat = self.clock.now - t0
                self._lat["scan"].record(lat)
                if ctx is not None:
                    self._finish_ctx(ctx, "scan", lat, t0)
            return out

    def _level_stream(self, files: List[FileMeta], start: bytes,
                      cls: IOClass = IOClass.USER_READ) -> Iterator[Entry]:
        for f in files:
            yield from self.reader(f.fid, cls).iter_from(start, cls)

    # ==================================================================
    # Table/reader plumbing
    # ==================================================================

    def reader(self, fid: int, cls: IOClass = IOClass.USER_READ
               ) -> KTableReader:
        r = self._readers.get(fid)
        if r is None:
            r = KTableReader(self.device, fid, self.cache, cls)
            self._readers[fid] = r
        return r  # type: ignore[return-value]

    def r_reader(self, fid: int) -> RTableReader:
        r = self._readers.get(fid)
        if r is None:
            r = RTableReader(self.device, fid, self.cache)
            self._readers[fid] = r
        return r  # type: ignore[return-value]

    def vb_reader(self, fid: int) -> VBTableReader:
        r = self._readers.get(fid)
        if r is None:
            r = VBTableReader(self.device, fid, self.cache)
            self._readers[fid] = r
        return r  # type: ignore[return-value]

    def log_reader(self, fid: int) -> LogTableReader:
        r = self._readers.get(fid)
        if r is None:
            r = LogTableReader(self.device, fid)
            self._readers[fid] = r
        return r  # type: ignore[return-value]

    def drop_table(self, fid: int) -> None:
        self._readers.pop(fid, None)
        self.cache.evict_file(fid)
        self.device.delete(fid)

    def _quarantine(self, fid: int) -> None:
        """A block of ``fid`` failed its checksum: drop the reader and
        every cached block (either may hold bytes decoded before the
        corruption landed), and count the file once.  The device bytes
        stay for forensics; intact blocks of the file remain readable
        through a fresh reader, so unaffected keys keep working."""
        if fid in self.quarantined:
            return
        self.quarantined.add(fid)
        self.device.block_stats.quarantined_files += 1
        self._readers.pop(fid, None)
        self.cache.evict_file(fid)

    def warm_open(self, fid: int, kind: str) -> None:
        """Open a just-written table for free — its footer/index pages are
        still in page cache (RocksDB table-cache + OS cache behaviour)."""
        if fid in self._readers or not self.device.exists(fid):
            return
        with self.device.uncharged():
            if kind == "ksst":
                self._readers[fid] = KTableReader(self.device, fid, self.cache)
            elif kind == "rtable":
                self._readers[fid] = RTableReader(self.device, fid, self.cache)
            elif kind == "btable":
                self._readers[fid] = VBTableReader(self.device, fid, self.cache)
            else:
                self._readers[fid] = LogTableReader(self.device, fid)

    def new_vsst_writer(self):
        opts = self.opts
        if opts.vsst_format == "rtable":
            return RTableWriter(self.device, codec=opts.block_compression,
                                min_ratio=opts.compression_min_ratio,
                                bits_per_key=opts.bloom_bits())
        if opts.vsst_format == "btable":
            return VBTableWriter(self.device, codec=opts.block_compression,
                                 min_ratio=opts.compression_min_ratio,
                                 bits_per_key=opts.bloom_bits())
        return LogTableWriter(self.device)

    def finish_vsst(self, writer, cls: IOClass, fid: Optional[int] = None,
                    is_hot: bool = False) -> VSSTMeta:
        fid, props = writer.finish(cls, fid=fid)
        self.warm_open(fid, self.opts.vsst_format)
        return VSSTMeta(
            fid=fid, file_size=props["file_size"],
            total_value_bytes=props["total_value_bytes"],
            live_value_bytes=props["total_value_bytes"],
            num_entries=props["num_entries"],
            fmt=self.opts.vsst_format, is_hot=is_hot)

    def make_ksst_meta(self, fid: int, props: dict, level: int) -> FileMeta:
        self.warm_open(fid, "ksst")
        return FileMeta(
            fid=fid, level=level, smallest=bytes(props["smallest"]),
            largest=bytes(props["largest"]), file_size=props["file_size"],
            num_entries=props["num_entries"],
            compensated_bytes=props["compensated_bytes"],
            value_refs={int(k): tuple(v)
                        for k, v in props["value_refs"].items()},
            table_type=props["table_type"])

    def retire_vsst(self, meta: VSSTMeta) -> None:
        """Handle a vSST whose live-byte counter reached zero.

        KA-mode accounting (address payload comparison at compaction) is
        exact, so the file is deleted immediately.  KF-mode accounting is
        an estimate (inheritance-chain attribution after GC moves), so the
        file defers to standalone GC, which validates every record before
        the file is dropped — a zero-live file sorts first in the greedy
        max-garbage-ratio pick."""
        if meta.pending_delete or meta.being_gc:
            return
        if self.opts.index_kind == "ka":
            meta.pending_delete = True
            self.versions.log_and_apply({"del_vsst": [meta.fid]})
            self.drop_table(meta.fid)

    @property
    def dropcache(self):
        """The shared heat sketch under its historical name (hot/cold
        vSST splitting reads membership; placement reads drop counts)."""
        return self.placement.heat

    def note_drop(self, ukey: bytes, old_bytes: int = 0) -> None:
        """A live version of ``ukey`` carrying ``old_bytes`` of value was
        shadowed — compaction entry drops and memtable overwrites both
        land here, feeding the heat sketch (paper III-B.3) and the
        placement engine's churn histogram."""
        if self.opts.dropcache or self.opts.adaptive_placement:
            self.placement.observe_drop(ukey, old_bytes)

    # ==================================================================
    # Background work
    # ==================================================================

    def maybe_schedule_background(self, stalled_for: Optional[str] = None
                                  ) -> None:
        # flush
        while self.immutables and self.sched.can_admit(JOB_FLUSH):
            imm, handle = self.immutables[0]
            busy = getattr(imm, "_flushing", False)
            if busy:
                break
            imm._flushing = True  # type: ignore[attr-defined]
            self.sched.run_job(JOB_FLUSH, lambda i=imm, h=handle:
                               self._flush_body(i, h),
                               trace_args={"shard": self.shard_tag})
        # compaction
        while self.sched.can_admit(JOB_COMPACTION):
            plan = plan_compaction(self.versions, self.opts)
            if plan is None:
                break
            self.sched.run_job(JOB_COMPACTION,
                               lambda p=plan: execute_compaction(self, p),
                               trace_args={"shard": self.shard_tag,
                                           "level": plan.level})
        # standalone GC.  Baselines (TerarkDB/Titan) evaluate the garbage
        # trigger only after a compaction completes (paper II-B); the
        # Scavenger+ dynamic scheduler re-evaluates continuously (III-D).
        if self.opts.kv_separation and self.opts.gc_mode == "standalone":
            forced = stalled_for == "space"
            if forced or self.opts.dynamic_scheduler or self._gc_check_pending:
                self._gc_check_pending = False
                while self.sched.can_admit(JOB_GC):
                    victim = pick_gc_candidate(self, forced=forced)
                    if victim is None:
                        break
                    if forced:
                        self.stats_counters["forced_gc"] += 1
                    self.sched.run_job(JOB_GC,
                                       lambda v=victim: self._gc_body(v),
                                       trace_args={"shard": self.shard_tag,
                                                   "victim": victim.fid,
                                                   "forced": forced})
        self._update_pressures()

    def _gc_body(self, victim: VSSTMeta):
        before = {c: self.device.stats.by_class[c].time_s
                  for c in GC_STEP_CLASSES}
        if self.opts.index_kind == "ka":
            effects = run_gc_titan(self, victim)
        else:
            effects = run_gc_terark(self, victim)
        for c in GC_STEP_CLASSES:
            self.gc_step_time[c.value] += \
                self.device.stats.by_class[c].time_s - before[c]
        return effects

    def _flush_body(self, imm: Memtable, handle: MemtableLog):
        opts = self.opts
        ksst_writers: List[Tuple[int, dict]] = []
        kw = KTableWriter(self.device, opts.block_bytes,
                          dtable=(opts.ksst_format == "dtable"),
                          bits_per_key=opts.bloom_bits(),
                          codec=opts.block_compression,
                          min_ratio=opts.compression_min_ratio, level=0)
        vsst_metas: List[VSSTMeta] = []
        vws: Dict[bool, Tuple[Optional[int], Optional[object]]] = {
            True: (None, None), False: (None, None)}
        flushed_bytes = 0

        def _seal_v(hot: bool) -> None:
            nonlocal flushed_bytes
            fid, w = vws[hot]
            if w is not None and w.num_entries:
                meta = self.finish_vsst(w, IOClass.FLUSH, fid=fid,
                                        is_hot=hot)
                # Physical file size, not logical payload bytes — flush
                # write-amp must equal the device's FLUSH-class bytes.
                flushed_bytes += meta.file_size
                vsst_metas.append(meta)
            vws[hot] = (None, None)

        def _vwriter(hot: bool):
            fid, w = vws[hot]
            if w is None or w.estimated_bytes >= opts.vsst_bytes:
                _seal_v(hot)
                fid = self.device.create()
                w = self.new_vsst_writer()
                vws[hot] = (fid, w)
            return fid, w

        prev_key: Optional[bytes] = None
        for ukey, (seq, vtype, payload) in imm.sorted_entries():
            newest = ukey != prev_key
            prev_key = ukey
            # Roll output tables only at key boundaries: splitting one
            # key's version run across two L0 files would break the
            # newest-first L0 probe (the younger fid — holding the OLDER
            # spillover versions — sorts first).
            if newest and kw.estimated_bytes >= opts.ksst_bytes:
                fid, props = kw.finish(IOClass.FLUSH)
                flushed_bytes += props["file_size"]
                ksst_writers.append((fid, props))
                kw = KTableWriter(self.device, opts.block_bytes,
                                  dtable=(opts.ksst_format == "dtable"),
                                  bits_per_key=opts.bloom_bits(),
                                  codec=opts.block_compression,
                                  min_ratio=opts.compression_min_ratio,
                                  level=0)
            # Snapshot-retained history versions (non-newest) are written
            # out verbatim — they are doomed duplicates that compaction
            # drops once their snapshots release, so separating them
            # would only mint value-store garbage.
            if (newest and vtype == VT_VALUE and opts.kv_separation
                    and self.placement.decide(ukey, len(payload))):
                hot = opts.dropcache and self.dropcache.is_hot(ukey)
                vfid, vw = _vwriter(hot)
                off, ln = vw.add(ukey, payload)
                if opts.index_kind == "ka":
                    entry = (ukey, seq, VT_INDEX_KA,
                             encode_ka(vfid, off, ln, raw=len(payload)))
                else:
                    entry = (ukey, seq, VT_INDEX_KF,
                             encode_kf(vfid, len(payload)))
            else:
                entry = (ukey, seq, vtype, payload)
            kw.add(entry)
        _seal_v(True)
        _seal_v(False)
        if kw.num_entries:
            fid, props = kw.finish(IOClass.FLUSH)
            flushed_bytes += props["file_size"]
            ksst_writers.append((fid, props))

        def effects(elapsed: float = 0.0) -> None:
            metas = [self.make_ksst_meta(fid, props, 0)
                     for fid, props in ksst_writers]
            # "seq" persists the sequence floor: once this flush lets the
            # segments holding these records be deleted, the manifest is
            # the only record of how far the shard's seqs reached — a
            # recovery that restarted below it would re-issue seqs that
            # compaction's (key, -seq) merge order treats as OLDER than
            # the flushed entries (and snapshot bounds would wrongly
            # filter flushed data).  Same rationale as "csn".
            self.versions.log_and_apply({
                "add_ksst": [(0, m) for m in metas],
                "add_vsst": vsst_metas,
                "seq": self.versions.seq,
                "csn": getattr(self.sink, "csn", 0),
            })
            if self.immutables and self.immutables[0][0] is imm:
                self.immutables.pop(0)
            else:   # defensive: remove wherever it is
                self.immutables = [(m, h) for m, h in self.immutables
                                   if m is not imm]
            self.sink.flushed(handle)
            for fid in handle.fids:
                self.versions.log_edit({"wal_done": fid})
                if fid in self.versions.pending_wals:
                    self.versions.pending_wals.remove(fid)
            self.stats_counters["flushes"] += 1
            self.placement.note_flush(
                sum(props["file_size"] for _, props in ksst_writers))
            # Write-amp attribution happens at the device per IOClass
            # (exact by construction) — only the governor's flush-rate
            # estimate is fed here.
            self.sched.note_flush(flushed_bytes, max(elapsed, 1e-9))
            self.after_background()

        return effects

    def after_background(self) -> None:
        self._update_pressures()
        self.maybe_schedule_background()

    # ==================================================================
    # Pressures & stats (paper eqs. 4-6)
    # ==================================================================

    def pressures(self) -> Tuple[float, float]:
        t = self.opts.level_multiplier
        nl = max(1, self.versions.num_nonempty_levels())
        ideal_index = 1.0 + sum(1.0 / t ** i for i in range(1, nl))
        p_index = self.versions.s_index() - ideal_index
        rg = self.opts.garbage_ratio
        p_value = self.versions.exposed_ratio() - rg / (1.0 - rg)
        return p_index, p_value

    def _update_pressures(self) -> None:
        p_i, p_v = self.pressures()
        self.sched.update_allocation(p_i, p_v)
        if self.opts.adaptive_placement:
            # Keep the cost model's tree-overhead term live (S_index is a
            # couple of list sums — cheap at this call rate).
            self.placement.note_tree(self.versions.s_index())
        # Roll the amplification-ledger window if due (engine lock held
        # here; a no-op comparison when it is not).
        self.obs.ledger.maybe_sample(self.clock.now)

    def drain(self, max_sim_s: float = 1e9) -> None:
        """Let all in-flight background work complete (quiesce)."""
        self.sched.core.drain(max_sim_s)

    def flush_all(self) -> None:
        """Force-rotate the active memtable and flush everything."""
        with self._fg():
            if len(self.mem):
                self._rotate_memtable()
            self.maybe_schedule_background()
        self.drain()

    def space_usage(self) -> Dict[str, float]:
        with self.sched.core.engine_lock:
            return self._space_usage_locked()

    def _space_usage_locked(self) -> Dict[str, float]:
        tot_v, live_v = self.versions.value_stats()
        lvl = self.versions.index_level_sizes()
        return {
            "total_bytes": self.device.total_bytes(),
            "index_bytes": sum(lvl),
            "index_level_bytes": lvl,
            # Logical (pre-codec) value bytes vs physical file footprint:
            # with compression on, value_file_bytes < value_total_bytes.
            "value_total_bytes": tot_v,
            "value_live_bytes": live_v,
            "value_file_bytes": sum(m.file_size
                                    for m in self.versions.vssts.values()),
            "s_index": self.versions.s_index(),
            "exposed_ratio": self.versions.exposed_ratio(),
            "global_garbage_ratio": self.versions.global_garbage_ratio(),
        }

    def stats(self) -> Dict[str, object]:
        with self.sched.core.engine_lock:
            return self._stats_locked()

    # -- observability (repro.obs) ---------------------------------------

    def metrics(self, *, sim_only: bool = False) -> Dict[str, object]:
        """Full observability snapshot: registry counter groups and
        histograms (with causal exemplars) plus the amplification ledger
        (per-source write-amp, per-component space-amp, windowed series),
        the device's per-class I/O totals, and the shared cache's budget
        accounting — everything the invariant auditor cross-checks.
        ``sim_only`` drops wall-clock-derived series so two seeded runs
        compare equal."""
        with self.sched.core.engine_lock:
            snap: Dict[str, object] = {"sim_time_s": self.clock.now}
            snap["registry"] = self.obs.snapshot(sim_only=sim_only)
            snap["amp"] = self.obs.ledger.snapshot()
            snap["io"] = self.device.stats.snapshot()
            snap["cache"] = self.cache.core.stats()
            return snap

    def audit(self) -> "AuditReport":
        """Run the conservation-law auditor over a fresh metrics
        snapshot; ``.ok`` is False iff any invariant is violated."""
        return audit_snapshot(self.metrics())

    def start_trace(self, recorder: Optional[TraceRecorder] = None
                    ) -> TraceRecorder:
        """Begin recording a Chrome trace (jobs, commit rounds, device
        I/O, governor/placement decisions) on the simulated clock."""
        if recorder is None:
            recorder = TraceRecorder(self.clock)
        with self.sched.core.engine_lock:
            self.device.tracer = recorder
            self.sched.core.tracer = recorder
        return recorder

    def stop_trace(self, path: Optional[str] = None
                   ) -> Optional[TraceRecorder]:
        with self.sched.core.engine_lock:
            recorder = self.device.tracer
            self.device.tracer = None
            self.sched.core.tracer = None
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

    def _trace_retune(self, threshold: int) -> None:
        tracer = self.sched.core.tracer
        if tracer is not None:
            tracer.instant("placement", "retune",
                           args={"shard": self.shard_tag,
                                 "threshold": threshold})

    def _stats_locked(self) -> Dict[str, object]:
        p_i, p_v = self.pressures()
        return {
            "sim_time_s": self.clock.now,
            "space": self._space_usage_locked(),
            "io": self.device.stats.snapshot(),
            "counters": dict(self.stats_counters),
            "gc_step_time_s": dict(self.gc_step_time),
            "cache_hit_ratio": self.cache.hit_ratio,
            # This shard's view of the (possibly shared) read cache:
            # quota, residency, hit/ghost-hit rates, per-class read heat.
            "cache": self.cache.stats(),
            "pressure_index": p_i,
            "pressure_value": p_v,
            "max_gc_threads": self.sched.max_gc,
            "gc_bw_fraction": self.sched.gc_write_limiter.fraction,
            # Core-level commit accounting: for a shard of a sharded store
            # the scheduler core — and therefore this counter — is shared
            # with its siblings (a group sync is one sync, not one per
            # shard), so read it once at the front-end, not per shard.
            "wal": self.sched.core.wal_stats(),
            "bg_write_bytes": self.sched.core.bg_write_stats(),
            # MVCC: the advisory global commit sequence this store has
            # seen and the snapshot bounds currently pinning versions.
            "mvcc": {"csn": getattr(self.sink, "csn", 0),
                     "active_snapshots": self.snapshots.count},
            "dropcache": {"size": len(self.dropcache),
                          "inserts": self.dropcache.inserts,
                          "hit_rate": (self.dropcache.hits /
                                       max(1, self.dropcache.queries))},
            "placement": self.placement.stats(),
            # Block I/O subsystem: codec bytes before/after per level,
            # filter probe outcomes, corruption/quarantine counts (the
            # device's counters — shared across a sharded store).
            "blocks": self.device.block_stats.snapshot(),
        }
