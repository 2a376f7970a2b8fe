"""Simulated block storage with an explicit I/O cost model.

The Scavenger+ paper measures *I/O counts, bytes and latencies* on an NVMe
SSD.  This module provides the device abstraction the whole engine runs on:

* every read/write is tagged with an :class:`IOClass` (user / flush / wal /
  compaction / gc-read / gc-write / ...) and charged against a cost model
  (per-op latency + bandwidth), advancing a simulated clock;
* a token-bucket :class:`RateLimiter` implements the paper's background
  bandwidth throttling (Section III-D.2);
* :class:`IOStats` gives the per-class op/byte totals used by the
  benchmark figures (Fig. 13(c) I/O analysis, Fig. 4 latency breakdown).

Data is held in memory (``MemBlockDevice``) so the engine is deterministic
and fast; ``FSBlockDevice`` stores the same byte streams in real files (used
by the checkpoint store for durability tests).
"""

from __future__ import annotations

import enum
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from ..obs.registry import MetricsRegistry
from .blockio import BlockCodecStats


class IOClass(enum.Enum):
    """Classification of an I/O request, mirroring the paper's breakdown."""

    USER_READ = "user_read"
    USER_WRITE = "user_write"
    WAL = "wal"
    FLUSH = "flush"
    COMPACTION_READ = "compaction_read"
    COMPACTION_WRITE = "compaction_write"
    GC_READ = "gc_read"
    GC_LOOKUP = "gc_lookup"          # index reads issued on behalf of GC
    GC_WRITE = "gc_write"
    GC_WRITE_INDEX = "gc_write_index"  # Titan-style index write-back
    MANIFEST = "manifest"
    CHECKPOINT = "checkpoint"

    @property
    def is_background(self) -> bool:
        return self not in (IOClass.USER_READ, IOClass.USER_WRITE, IOClass.WAL)

    @property
    def is_gc(self) -> bool:
        return self in (IOClass.GC_READ, IOClass.GC_LOOKUP, IOClass.GC_WRITE,
                        IOClass.GC_WRITE_INDEX)


@dataclass
class CostModel:
    """NVMe-SSD-like cost model (defaults approximate the paper's testbed,

    a 500 GB KIOXIA NVMe: ~80 us random-read latency, ~20 us buffered write
    submit, ~3.2 GB/s read and ~2.0 GB/s write bandwidth).
    """

    read_latency_s: float = 80e-6
    write_latency_s: float = 20e-6
    read_bw: float = 3.2e9      # bytes / second
    write_bw: float = 2.0e9
    cpu_op_s: float = 2e-6      # CPU cost charged per engine op (lookup etc.)

    def read_cost(self, nbytes: int) -> float:
        return self.read_latency_s + nbytes / self.read_bw

    def write_cost(self, nbytes: int) -> float:
        return self.write_latency_s + nbytes / self.write_bw


class Clock:
    """Simulated monotonic clock (seconds).

    When ``sink`` is set (a single-element list), time charges accumulate
    there instead of advancing ``now`` — used to measure background-job
    durations without moving global time (see scheduler.JobClock)."""

    __slots__ = ("now", "sink")

    def __init__(self) -> None:
        self.now = 0.0
        self.sink = None

    def advance(self, dt: float) -> float:
        assert dt >= 0.0
        if self.sink is not None:
            self.sink[0] += dt
            return self.now
        self.now += dt
        return self.now

    def advance_to(self, t: float) -> float:
        if t > self.now:
            self.now = t
        return self.now


@dataclass
class ClassStats:
    ops: int = 0
    bytes: int = 0
    time_s: float = 0.0

    def add(self, nbytes: int, dt: float) -> None:
        self.ops += 1
        self.bytes += nbytes
        self.time_s += dt


class IOStats:
    """Per-:class:`IOClass` op/byte/time accounting."""

    def __init__(self) -> None:
        self.by_class: Dict[IOClass, ClassStats] = {c: ClassStats() for c in IOClass}

    def add(self, cls: IOClass, nbytes: int, dt: float) -> None:
        self.by_class[cls].add(nbytes, dt)

    def total(self, *classes: IOClass) -> ClassStats:
        out = ClassStats()
        for c in classes or tuple(IOClass):
            s = self.by_class[c]
            out.ops += s.ops
            out.bytes += s.bytes
            out.time_s += s.time_s
        return out

    def read_bytes(self) -> int:
        return self.total(IOClass.USER_READ, IOClass.COMPACTION_READ,
                          IOClass.GC_READ, IOClass.GC_LOOKUP).bytes

    def write_bytes(self) -> int:
        return self.total(IOClass.USER_WRITE, IOClass.WAL, IOClass.FLUSH,
                          IOClass.COMPACTION_WRITE, IOClass.GC_WRITE,
                          IOClass.GC_WRITE_INDEX, IOClass.MANIFEST).bytes

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {c.value: {"ops": s.ops, "bytes": s.bytes, "time_s": s.time_s}
                for c, s in self.by_class.items() if s.ops}


class RateLimiter:
    """Token-bucket limiter over *simulated* time.

    Used to throttle background GC bandwidth (paper Section III-D.2): when
    the engine detects flush-bandwidth degradation it lowers ``rate_bps`` in
    20 % steps; charging more bytes than available tokens returns the extra
    delay the requester must absorb.
    """

    def __init__(self, clock: Clock, rate_bps: float, burst_s: float = 0.05) -> None:
        self.clock = clock
        self.base_rate = rate_bps
        self.rate = rate_bps
        self.burst_s = burst_s
        self._tokens = rate_bps * burst_s
        self._last = clock.now

    def _refill(self) -> None:
        now = self.clock.now
        self._tokens = min(self.rate * self.burst_s,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def charge(self, nbytes: int) -> float:
        """Consume tokens; return extra delay (s) imposed by throttling."""
        if self.rate <= 0 or nbytes <= 0:
            return 0.0
        self._refill()
        self._tokens -= nbytes
        if self._tokens >= 0:
            return 0.0
        delay = -self._tokens / self.rate
        # Tokens go further negative; the borrower pays the delay now.
        return delay

    def set_fraction(self, frac: float) -> None:
        self.rate = max(0.05, min(1.0, frac)) * self.base_rate

    @property
    def fraction(self) -> float:
        return self.rate / self.base_rate


class BlockDevice:
    """In-memory append-only file store with cost accounting.

    Files are identified by integer ids.  Writers append; readers read
    ``(offset, length)`` ranges.  All costs advance ``clock`` and are
    recorded in ``stats`` under the supplied :class:`IOClass`.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 cost: Optional[CostModel] = None) -> None:
        self.clock = clock or Clock()
        self.cost = cost or CostModel()
        self.stats = IOStats()
        # Block-subsystem counters (codec bytes, filter probes, corruption)
        # live on the device like IOStats: every writer/reader already holds
        # the device, and a sharded store shares one set of counters.
        self.block_stats = BlockCodecStats()
        # Observability: the metrics registry shares the device's
        # lifetime (counters survive crash/recovery re-attachment), and
        # an active TraceRecorder sees every charged I/O as an X event.
        self.metrics = MetricsRegistry()
        self.tracer = None
        # Background write bytes are attributed centrally here, per I/O
        # class, so the amplification ledger's write sources equal the
        # device's class totals *by construction* (the audit relies on
        # this).  GC-class writes are shared between the GC and the
        # rebalancer; the current owner is a dynamically-scoped tag.
        self._bg_write = self.metrics.counters(
            "core/bg_write_bytes",
            {"flush": 0, "compaction": 0, "gc": 0, "migrate": 0})
        self.gc_write_attr = "gc"
        self._discard_stats = False
        self._files: Dict[int, bytearray] = {}
        self._next_id = 1
        self.gc_read_limiter: Optional[RateLimiter] = None
        self.gc_write_limiter: Optional[RateLimiter] = None
        # charge_time=False turns the device into a pure byte-store (used
        # while replaying WAL/manifest at recovery, which is not charged).
        self.charge_time = True
        # Shared-bandwidth channels: background I/O queues behind all
        # previously issued bytes (an SSD has one flash array, however
        # many threads submit); foreground I/O jumps the queue but still
        # consumes capacity.  This contention is what makes GC compete
        # with user traffic (paper Section III-D).
        self._read_busy_until = 0.0
        self._write_busy_until = 0.0

    def _io_time(self, nbytes: int, is_write: bool, cls: IOClass) -> float:
        lat = (self.cost.write_latency_s if is_write
               else self.cost.read_latency_s)
        bw = self.cost.write_bw if is_write else self.cost.read_bw
        service = nbytes / bw
        now = self.clock.now
        attr = "_write_busy_until" if is_write else "_read_busy_until"
        busy = max(getattr(self, attr), now)
        setattr(self, attr, busy + service)
        if cls.is_background:
            return (busy - now) + service + lat
        return service + lat

    # -- file lifecycle -------------------------------------------------
    def create(self) -> int:
        fid = self._next_id
        self._next_id += 1
        self._files[fid] = bytearray()
        return fid

    def delete(self, fid: int) -> None:
        self._files.pop(fid, None)

    def exists(self, fid: int) -> bool:
        return fid in self._files

    def size(self, fid: int) -> int:
        return len(self._files[fid])

    def file_ids(self) -> Iterator[int]:
        return iter(tuple(self._files))

    def total_bytes(self) -> int:
        return sum(len(b) for b in self._files.values())

    # -- I/O -------------------------------------------------------------
    def append(self, fid: int, data: bytes, cls: IOClass) -> int:
        """Append ``data``; returns the offset it was written at."""
        buf = self._files[fid]
        off = len(buf)
        buf += data
        dt = self._io_time(len(data), True, cls) if self.charge_time else 0.0
        if cls.is_gc and self.gc_write_limiter is not None:
            dt += self.gc_write_limiter.charge(len(data))
        self.stats.add(cls, len(data), dt)
        if not self._discard_stats:
            if cls is IOClass.FLUSH:
                self._bg_write["flush"] += len(data)
            elif cls is IOClass.COMPACTION_WRITE:
                self._bg_write["compaction"] += len(data)
            elif cls is IOClass.GC_WRITE or cls is IOClass.GC_WRITE_INDEX:
                attr = self.gc_write_attr
                self._bg_write[attr] = self._bg_write.get(attr, 0) + len(data)
        if self.charge_time:
            if self.clock.sink is None and self.metrics.causal.depth:
                self.metrics.causal.on_io(cls.value, True, len(data), dt, fid)
            if self.tracer is not None:
                self.tracer.complete(f"io/{cls.name.lower()}", "write",
                                     self.clock.now, dt,
                                     {"bytes": len(data), "fid": fid})
            self.clock.advance(dt)
        return off

    def read(self, fid: int, offset: int, length: int, cls: IOClass) -> bytes:
        buf = self._files[fid]
        data = bytes(buf[offset:offset + length])
        dt = self._io_time(len(data), False, cls) if self.charge_time else 0.0
        if cls.is_gc and self.gc_read_limiter is not None:
            dt += self.gc_read_limiter.charge(len(data))
        self.stats.add(cls, len(data), dt)
        if self.charge_time:
            if self.clock.sink is None and self.metrics.causal.depth:
                self.metrics.causal.on_io(cls.value, False, len(data), dt,
                                          fid)
            if self.tracer is not None:
                self.tracer.complete(f"io/{cls.name.lower()}", "read",
                                     self.clock.now, dt,
                                     {"bytes": len(data), "fid": fid})
            self.clock.advance(dt)
        return data

    def read_all(self, fid: int, cls: IOClass) -> bytes:
        return self.read(fid, 0, len(self._files[fid]), cls)

    def charge_cpu(self, n_ops: int = 1) -> None:
        if self.charge_time:
            dt = self.cost.cpu_op_s * n_ops
            if self.clock.sink is None and self.metrics.causal.depth:
                self.metrics.causal.on_cpu(dt)
            self.clock.advance(dt)

    @contextmanager
    def attribute_gc_writes(self, kind: str):
        """Dynamically scope the owner of GC-class write bytes ("gc" or
        "migrate") for background-write attribution."""
        prev = self.gc_write_attr
        self.gc_write_attr = kind
        try:
            yield
        finally:
            self.gc_write_attr = prev

    @contextmanager
    def uncharged(self):
        """No-cost window: models page-cache hits on freshly written file
        metadata (e.g. re-opening a table the engine just wrote)."""
        saved_ct, saved_stats = self.charge_time, self.stats
        self.charge_time = False
        self.stats = IOStats()          # discard
        self._discard_stats = True
        try:
            yield
        finally:
            self.charge_time, self.stats = saved_ct, saved_stats
            self._discard_stats = False

    @contextmanager
    def time_free(self):
        """Suspend time charging but keep op/byte accounting (recovery
        replay: reads still count, the clock does not move).  Unlike
        :meth:`uncharged`, stats are preserved, and unlike a bare
        ``charge_time = False`` toggle, an exception mid-window (corrupt
        segment, stale superblock) cannot leave charging disabled."""
        saved_ct = self.charge_time
        self.charge_time = False
        try:
            yield
        finally:
            self.charge_time = saved_ct


class FSBlockDevice(BlockDevice):
    """Same interface, but bytes also live in real files under ``root``.

    Simulated-time accounting is kept (tests remain deterministic); the real
    files provide durability for the checkpoint store.
    """

    def __init__(self, root: str, clock: Optional[Clock] = None,
                 cost: Optional[CostModel] = None) -> None:
        super().__init__(clock, cost)
        self.root = root
        os.makedirs(root, exist_ok=True)
        # Recover pre-existing files (crash-restart path).
        for name in os.listdir(root):
            if name.endswith(".blk"):
                fid = int(name[:-4])
                with open(os.path.join(root, name), "rb") as f:
                    self._files[fid] = bytearray(f.read())
                self._next_id = max(self._next_id, fid + 1)

    def _path(self, fid: int) -> str:
        return os.path.join(self.root, f"{fid}.blk")

    def create(self) -> int:
        fid = super().create()
        open(self._path(fid), "wb").close()
        return fid

    def delete(self, fid: int) -> None:
        super().delete(fid)
        try:
            os.remove(self._path(fid))
        except FileNotFoundError:
            pass

    def append(self, fid: int, data: bytes, cls: IOClass) -> int:
        off = super().append(fid, data, cls)
        with open(self._path(fid), "ab") as f:
            f.write(data)
        return off
