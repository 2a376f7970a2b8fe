"""Group-commit write-ahead logging (the commit pipeline).

The paper's dynamic GC scheduler (Section III-D) exists because foreground
writes and background I/O fight over one device budget; the WAL is the
foreground half of that fight.  This module extracts WAL ownership out of
``KVStore`` into two commit sinks behind one interface:

* :class:`SoloCommitSink` — a standalone store's WAL exactly as before:
  one log file per memtable, one device append (≈ one sync) per record.
* :class:`SharedCommitSink` — a shard's view over a single
  :class:`GroupCommitLog` shared by every shard of a ``ShardedKVStore``.
  Records are framed with a *shard tag* and interleaved in shared segment
  files.

Both sinks share the :class:`CommitPipeline` leader/follower protocol.  A
client thread's ``write_batch`` opens a commit *group*: its encoded
records enqueue (memtable apply proceeds immediately) and the thread
blocks on the commit condition at group exit until a published *durable
sequence* covers its last record.  Whichever closing thread finds no
active leader becomes the leader: it lingers while other groups are still
open — so the WAL append of batch N overlaps the memtable apply of the
batches that will ride sync N+0 — then drains the whole queue with one
coalesced device append and publishes the new durable sequence.  With T
client threads the steady state coalesces ~T batches per device sync.

Durability ordering is preserved at every boundary that can expose state:
segment rotation, non-WAL-class appends (Titan GC write-back) and group
exit all force the pending queue to the device first, so a segment's byte
order equals per-shard sequence order and crash replay stays a single
forward pass (torn tails tolerated, exactly like the solo WAL).

Locking (see ``core.concurrency`` for the full hierarchy): the queue
mutex ``_qmu`` is a leaf — it may be taken while holding the engine lock
(the drain does: engine -> _qmu -> device append), but a thread holding
``_qmu`` never blocks on the engine lock; and a thread NEVER waits on the
commit condition while holding the engine lock, because the leader needs
the engine lock to drain.  Group exit therefore happens after the per-op
engine sections inside the batch have been released.

Sync accounting is routed through :class:`~.scheduler.SchedulerCore`
(``note_wal_sync``) so the bandwidth governor sees a batch as one charged
sync, not N appends — and so benchmarks can report ``wal_syncs/op``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, List, Optional, Tuple

from ..store.blocks import decode_record, decode_varint, encode_varint
from ..store.device import BlockDevice, IOClass
from ..store.memtable import WAL, encode_wal_record

#: Reserved shard tag framing a commit sequence number (CSN) stamp in a
#: shared segment.  The leader allocates one CSN per commit round and
#: writes ``varint(CSN_TAG) + wal_record(b"", csn, 0, b"")`` at the head
#: of the round's coalesced append; replay restores ``csn = max(stamps)``.
#: Far above any plausible shard count, so the stale-superblock
#: shard-count check in recovery stays meaningful for real tags.
CSN_TAG = (1 << 20) - 1


@dataclasses.dataclass
class MemtableLog:
    """Handle for the log extent(s) backing one memtable.

    A solo memtable owns exactly one WAL file; a shard's memtable may span
    several shared segments (another shard's rotation moves the active
    segment under it).  The handle travels with the immutable memtable and
    is released when its flush completes.
    """

    fids: List[int] = dataclasses.field(default_factory=list)


class CommitPipeline:
    """Leader/follower commit queue shared by both sinks.

    State machine (all queue state guarded by the leaf mutex ``_qmu``):

    * ``_enq`` — records enqueued ever; a thread's *ticket* is the value
      of ``_enq`` after its last enqueue (or ``_durable`` at group open,
      so read-only groups exit without waiting).
    * ``_durable`` — published durable sequence.  The drain is atomic
      under ``engine + _qmu``: it pops the whole queue, writes one
      coalesced append, then publishes ``_durable = _enq`` (nobody can
      enqueue while ``_qmu`` is held, so queue-empty implies covered).
      On a device error the popped records are re-queued so a later
      drain retries them — no silent loss.
    * ``_open_groups`` / ``_leader_active`` — a closing thread whose
      ticket is not yet durable becomes leader iff no leader is active;
      the leader lingers while groups are still open (their appends ride
      this sync — the pipelining overlap), then drains.  Everyone else
      waits on ``_qcond`` holding only ``_qmu`` (and possibly a shard
      latch / routing read hold — never the engine lock).

    Termination: open groups belong to threads actively executing batch
    bodies (they never wait on ``_qcond`` mid-group), every close
    notifies, and the linger wait carries a timeout as a backstop.
    """

    #: Leader commit delay once >1 client thread has been seen: one timed
    #: wait per round lets concurrently-running clients (who may not have
    #: reached their group yet — the GIL runs threads in long slices) land
    #: their batches in this sync.  Single-threaded pipelines never wait.
    LINGER_S = 0.0002

    def _pipeline_init(self, core) -> None:
        self.core = core                     # SchedulerCore (sync accounting)
        self._qmu = threading.Lock()
        self._qcond = threading.Condition(self._qmu)
        self._queue: List[bytes] = []        # encoded records awaiting sync
        self._queue_records = 0
        self._enq = 0
        self._durable = 0
        # Global commit sequence number: one per commit round (each
        # coalesced drain or write-through WAL append), allocated by the
        # leader under the engine lock.  MVCC snapshots record it as the
        # advisory cross-shard commit point; recovery restores it from
        # segment stamps and manifest "csn" edits (see version.py).
        self.csn = 0
        self._open_groups = 0
        self._leader_active = False
        self._client_idents: set = set()     # threads that opened groups
        self._mt = False                     # >1 client thread ever seen
        self._tls = threading.local()
        # The engine lock serializes the device append; a core-less
        # pipeline (unit tests) gets a private stand-in.
        self._engine = (core.engine_lock if core is not None
                        else threading.RLock())
        # Wall-clock time threads spend parked on the commit condition
        # (distinct from the simulated-time admission stalls in db.py).
        # Registry-backed under the "wall/" prefix so deterministic
        # (sim-only) snapshots exclude it.  All writers hold ``_qmu``.
        self._wallc = (core.device.metrics.counters(
            "wall/commit_pipeline", {"wait_s": 0.0, "waits": 0})
            if core is not None else None)
        # Commit-wait distribution, also wall-clock-derived and therefore
        # wall/-prefixed: sim-only snapshots must exclude it or two
        # same-seed threaded runs diverge.
        self._wallh = (core.device.metrics.histogram("wall/commit_wait")
                       if core is not None else None)

    def _note_wait(self, waited: float) -> None:
        """Account wall-clock time spent parked on the commit condition
        (caller holds ``_qmu``)."""
        if not waited:
            return
        if self._wallc is not None:
            self._wallc["wait_s"] += waited
            self._wallc["waits"] += 1
        if self._wallh is not None and self.core.device.metrics.sampling:
            self._wallh.record(waited)

    def _drain_write(self, recs: List[bytes], n: int) -> None:
        raise NotImplementedError

    # -- groups ----------------------------------------------------------
    @contextmanager
    def group(self):
        """Open a commit group.  Nested frames are free riders; only the
        outermost frame's exit takes part in the leader/follower commit."""
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        if depth == 0:
            with self._qmu:
                self._open_groups += 1
                self._tls.ticket = self._durable
                if not self._mt:
                    self._client_idents.add(threading.get_ident())
                    self._mt = len(self._client_idents) > 1
        try:
            yield self
        finally:
            self._tls.depth -= 1
            if self._tls.depth == 0:
                self._group_exit()

    @property
    def in_group(self) -> bool:
        return getattr(self._tls, "depth", 0) > 0

    def _enqueue(self, rec: bytes) -> None:
        with self._qmu:
            self._queue.append(rec)
            self._queue_records += 1
            self._enq += 1
            self._tls.ticket = self._enq

    def _drain_locked(self) -> None:
        """Pop + write + publish.  Caller holds engine AND ``_qmu``."""
        if not self._queue:
            return
        recs, n = self._queue, self._queue_records
        self._queue, self._queue_records = [], 0
        try:
            self._drain_write(recs, n)
        except BaseException:
            # Put them back: a later drain (or the next leader) retries.
            self._queue[:0] = recs
            self._queue_records += n
            raise
        self._durable = self._enq
        self._qcond.notify_all()

    def sync(self) -> None:
        """Make everything enqueued so far durable (one coalesced append).
        Safe to call while already holding the engine lock (reentrant)."""
        with self._engine:
            with self._qmu:
                self._drain_locked()

    def _group_exit(self) -> None:
        with self._qmu:
            self._open_groups -= 1
            self._qcond.notify_all()
            waited = 0.0
            while True:
                if self._durable >= self._tls.ticket:
                    self._note_wait(waited)
                    return               # someone else's sync covered us
                if not self._leader_active:
                    self._leader_active = True
                    break                # we lead this commit round
                t0 = time.perf_counter()
                self._qcond.wait()       # follower: leader will publish
                waited += time.perf_counter() - t0
            self._note_wait(waited)
            # Leader linger: while other groups are still open their
            # records are still arriving; wait so they ride this sync
            # (batch N's append overlaps batch N+1's memtable apply).
            # With multiple client threads, linger one extra beat even
            # with no group open — peers may not have reached theirs yet
            # (the GIL schedules threads in multi-ms slices; the timed
            # wait yields it so they enqueue and park as followers) —
            # and keep lingering while records are still landing.
            if self._mt:
                while True:
                    enq0 = self._enq
                    self._qcond.wait(timeout=self.LINGER_S)
                    if self._enq == enq0 and self._open_groups == 0:
                        break
            else:
                while self._open_groups > 0:
                    self._qcond.wait(timeout=0.05)
        try:
            self.sync()
        finally:
            with self._qmu:
                self._leader_active = False
                self._qcond.notify_all()


class SoloCommitSink(CommitPipeline):
    """Standalone-store WAL semantics behind the sink interface: one file
    per memtable, one device append (≈ one sync) per record — plus the
    :class:`CommitPipeline` commit group for ``KVStore.write_batch``:
    inside a :meth:`group` frame, encoded records queue and the commit
    leader drains them with one coalesced append, so a solo store
    amortizes WAL syncs the same way the shards of a sharded store do."""

    def __init__(self, device: BlockDevice, core=None) -> None:
        self.device = device
        self.on_open: Optional[Callable[[int], None]] = None
        self._wal: Optional[WAL] = None
        self._pipeline_init(core)

    def start(self) -> None:
        self._open()

    def _open(self) -> None:
        self._wal = WAL(self.device)
        if self.on_open is not None:
            self.on_open(self._wal.fid)

    def append(self, ukey: bytes, seq: int, vtype: int, payload: bytes,
               cls: IOClass = IOClass.WAL) -> None:
        if self.in_group and cls == IOClass.WAL:
            self._enqueue(encode_wal_record(ukey, seq, vtype, payload))
            return
        # Out-of-band class (Titan GC write-back) or no group open: flush
        # the queue first so file byte order equals sequence order.
        with self._engine:
            with self._qmu:
                self._drain_locked()
            nbytes = self._wal.append(ukey, seq, vtype, payload, cls)
            # Only foreground WAL commits count as syncs; out-of-band
            # classes are charged to their own I/O class and governed by
            # the GC limiters already.
            if cls == IOClass.WAL:
                self.csn += 1       # a write-through append is its own round
                if self.core is not None:
                    self.core.note_wal_sync(nbytes, 1)
                self.device.metrics.causal.commit_round(self.csn, 1, nbytes)

    def _drain_write(self, recs: List[bytes], n: int) -> None:
        buf = b"".join(recs)
        self.csn += 1
        tracer = self.core.tracer if self.core is not None else None
        t0 = self.device.clock.now
        self.device.append(self._wal.fid, buf, IOClass.WAL)
        if tracer is not None:
            tracer.span("commit", "commit_round", t0, self.device.clock.now,
                        {"records": n, "bytes": len(buf), "csn": self.csn})
        if self.core is not None:
            self.core.note_wal_sync(len(buf), n)
        self.device.metrics.causal.commit_round(self.csn, n, len(buf))

    def rotate(self) -> MemtableLog:
        with self._engine:
            self.sync()      # pending records belong to the old file
            handle = MemtableLog([self._wal.fid])
            self._open()
            return handle

    def flushed(self, handle: MemtableLog) -> None:
        for fid in handle.fids:
            self.device.delete(fid)


class GroupCommitLog(CommitPipeline):
    """One write-ahead log shared by every shard of a sharded store.

    Records are framed ``varint(shard_tag) + wal_record`` and appended to
    the *active segment*.  Inside a commit group, encoded records queue
    and the commit leader issues a single coalesced device append;
    outside a group each record is appended (synced) immediately,
    preserving single-op durability semantics.

    Segment lifecycle mirrors RocksDB's shared WAL across column families:
    any shard's memtable rotation rotates the segment, and a segment is
    deleted once every memtable holding records in it has flushed
    (refcounts via :meth:`retain`/:meth:`release`; the active segment is
    never deleted).  ``active_fid``, the refcounts and rotation are all
    engine-lock state: append/retain run under the caller's foreground
    engine section, release under flush effects inside ``pump``.
    """

    def __init__(self, device: BlockDevice, core=None) -> None:
        self.device = device
        self.active_fid = device.create()
        self._refs: dict = {}                # segment fid -> live handles
        self.syncs = 0
        self.records = 0
        self.bytes = 0
        self._pipeline_init(core)

    def append(self, shard_tag: int, ukey: bytes, seq: int, vtype: int,
               payload: bytes, cls: IOClass = IOClass.WAL) -> int:
        """Append one framed record; returns the segment fid it targets.

        Callers hold the engine lock (foreground op or job body), so the
        active segment cannot rotate under the returned fid: a queued
        record is physically drained into its segment before any rotation
        swaps ``active_fid`` (rotation syncs first)."""
        rec = encode_varint(shard_tag) + encode_wal_record(
            ukey, seq, vtype, payload)
        if self.in_group and cls == IOClass.WAL:
            self._enqueue(rec)
        else:
            # Out-of-band class (e.g. Titan GC write-back) or no group
            # open: flush the queue first so segment byte order equals
            # per-shard sequence order, then write through.
            with self._engine:
                with self._qmu:
                    self._drain_locked()
                    self._write_out([rec], 1, cls)
        return self.active_fid

    def _drain_write(self, recs: List[bytes], n: int) -> None:
        self._write_out(recs, n, IOClass.WAL)

    def _write_out(self, recs: List[bytes], n: int, cls: IOClass) -> None:
        buf = b"".join(recs)
        # Foreground WAL commits only — out-of-band classes (Titan GC
        # write-back) are charged to their own I/O class and already
        # governed by the GC limiters; counting them here would skew
        # wal_syncs/op and feed GC bytes into the governor's foreground
        # write window.  Each WAL round gets one CSN, stamped at the head
        # of the coalesced append so crash replay recovers the counter.
        if cls == IOClass.WAL:
            self.csn += 1
            buf = (encode_varint(CSN_TAG)
                   + encode_wal_record(b"", self.csn, 0, b"")) + buf
        tracer = self.core.tracer if self.core is not None else None
        t0 = self.device.clock.now
        self.device.append(self.active_fid, buf, cls)
        if tracer is not None and cls == IOClass.WAL:
            tracer.span("commit", "commit_round", t0, self.device.clock.now,
                        {"records": n, "bytes": len(buf), "csn": self.csn})
        if cls == IOClass.WAL:
            self.syncs += 1
            self.records += n
            self.bytes += len(buf)
            if self.core is not None:
                self.core.note_wal_sync(len(buf), n)
            self.device.metrics.causal.commit_round(self.csn, n, len(buf))

    # -- segment lifecycle ----------------------------------------------
    def retain(self, fid: int) -> None:
        self._refs[fid] = self._refs.get(fid, 0) + 1

    def release(self, fids: List[int]) -> None:
        for fid in fids:
            n = self._refs.get(fid, 0) - 1
            self._refs[fid] = n
            if n <= 0 and fid != self.active_fid:
                self._drop(fid)

    def rotate_segment(self) -> int:
        """Start a new segment (any shard's memtable rotation lands here).
        Pending records are synced first — they belong to the old extent."""
        with self._engine:
            self.sync()
            old = self.active_fid
            self.active_fid = self.device.create()
            if self._refs.get(old, 0) <= 0:
                self._drop(old)
            return self.active_fid

    def _drop(self, fid: int) -> None:
        self._refs.pop(fid, None)
        self.device.delete(fid)

    # -- crash replay ----------------------------------------------------
    @staticmethod
    def replay(device: BlockDevice, fid: int
               ) -> Iterator[Tuple[int, bytes, int, int, bytes]]:
        """Yield ``(shard_tag, ukey, seq, vtype, payload)`` from one
        segment.  Stops cleanly at a torn tail: a record whose varint
        header runs off the buffer *or* whose declared key/payload length
        exceeds the remaining bytes is discarded along with everything
        after it (a partial group append never surfaces half a record)."""
        buf = device.read_all(fid, IOClass.MANIFEST)
        n = len(buf)
        pos = 0
        while pos < n:
            try:
                tag, p = decode_varint(buf, pos)
                seq, p = decode_varint(buf, p)
                vtype, p = decode_varint(buf, p)
                ukey, payload, p = decode_record(buf, p)
            except IndexError:          # varint ran off the torn tail
                return
            if p > n:                   # body truncated mid-key/payload
                return
            pos = p
            yield tag, ukey, seq, vtype, payload


class SharedCommitSink:
    """One shard's commit view over a :class:`GroupCommitLog`.

    Tracks which shared segments the shard's *current* memtable has
    records in; the first record into a segment retains it and fires
    ``on_open`` so the shard's manifest can log the dependency (the same
    ``{"wal": fid}`` edit a solo store writes, now possibly several per
    memtable).  The handle is engine-lock state: appends happen inside
    the owning shard's foreground engine section, rotation inside the
    shard's ``_rotate_memtable`` (also under the engine lock)."""

    def __init__(self, log: GroupCommitLog, shard_tag: int) -> None:
        self.log = log
        self.tag = shard_tag
        self.on_open: Optional[Callable[[int], None]] = None
        self._handle = MemtableLog()

    def start(self) -> None:
        pass                    # segments are claimed lazily, on first write

    @property
    def csn(self) -> int:
        return self.log.csn

    def group(self):
        """The shard-level view of a commit group (delegates to the shared
        log), so ``KVStore.write_batch`` amortizes syncs whether the store
        is standalone or a shard of a sharded front-end."""
        return self.log.group()

    def append(self, ukey: bytes, seq: int, vtype: int, payload: bytes,
               cls: IOClass = IOClass.WAL) -> None:
        fid = self.log.append(self.tag, ukey, seq, vtype, payload, cls)
        if fid not in self._handle.fids:
            self._handle.fids.append(fid)
            self.log.retain(fid)
            if self.on_open is not None:
                self.on_open(fid)

    def rotate(self) -> MemtableLog:
        handle = self._handle
        self._handle = MemtableLog()
        self.log.rotate_segment()
        return handle

    def flushed(self, handle: MemtableLog) -> None:
        self.log.release(handle.fids)
