"""Background job scheduling: lanes, event pump, dynamic GC thread
allocation (paper eqs. 4-6) and GC bandwidth throttling (paper III-D.2).

The engine is a discrete-event simulation over the device's simulated
clock: background jobs execute their real work eagerly (so data structures
are exact) while their I/O time is accumulated into a *job duration*; the
job's **effects** (version edits, file deletions) apply when the clock
reaches the job's completion time on its assigned lane.  This models lane
(thread) contention, stalls and scheduling policy without OS threads —
deterministic and unit-testable.

Ownership is split in two so that several store instances (the shards of a
``ShardedKVStore``) can compete for one background-thread pool the way
RocksDB column families share ``Env`` threads:

* :class:`SchedulerCore` — the shared substrate: lane pools, the event
  heap, per-kind active counts, the GC rate limiters and the bandwidth
  governor.  Admission and the dynamic GC allocation (eqs. 4-6, over the
  *summed* member pressures) are arbitrated here, globally.
* :class:`Scheduler` — a per-store view over a core.  Constructed without
  an explicit core it creates a private one, preserving the single-store
  admission/allocation policy (one behavioural addition over the original:
  every job completion re-offers admission to all registered members, so
  pending background work is picked up as soon as a lane frees).

Concurrency discipline
----------------------
``SchedulerCore.engine_lock`` is THE single serialization point for the
simulated engine: the clock, device I/O charging, the event heap, lanes,
admission counters, the governor window and every version/memtable
structure the event effects mutate.  Client threads hold it for the span
of one foreground op (``KVStore._fg``) or one background job
(``Scheduler.run_job``); every ``pump``/``wait_for_event`` runs under it,
so effects fired by one thread's pump can safely touch any shard's state.
See ``core.concurrency`` for the full lock ordering (routing read-write
lock -> per-shard latch -> engine lock -> leaf mutexes).  The one hard
rule encoded here: **a thread never blocks on a condition variable while
holding the engine lock** — commit-group followers wait on the commit
condition only after their per-op engine sections have been released.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..store.device import BlockDevice, Clock, RateLimiter

JOB_FLUSH = "flush"
JOB_COMPACTION = "compaction"
JOB_GC = "gc"
JOB_MIGRATE = "migrate"          # slot migration (online shard rebalancing)


class JobClock:
    """Context manager that redirects device time charges into a local
    accumulator while a background job body runs."""

    def __init__(self, device: BlockDevice) -> None:
        self.device = device
        self._sink = [0.0]

    @property
    def elapsed(self) -> float:
        return self._sink[0]

    def __enter__(self) -> "JobClock":
        self._outer = self.device.clock.sink
        self.device.clock.sink = self._sink
        return self

    def __exit__(self, *exc) -> None:
        self.device.clock.sink = self._outer
        if self._outer is not None:      # nested job: charge parent too
            self._outer[0] += self._sink[0]


class Lanes:
    """A pool of background execution lanes with per-kind admission."""

    def __init__(self, n: int) -> None:
        self.free_at = [0.0] * n

    def earliest(self) -> int:
        return min(range(len(self.free_at)), key=lambda i: self.free_at[i])

    def busy_count(self, now: float) -> int:
        return sum(1 for t in self.free_at if t > now)

    def schedule(self, now: float, duration: float) -> Tuple[int, float, float]:
        """Place ``duration`` on the earliest-free lane; returns
        ``(lane, start, end)`` so callers can attribute the span."""
        i = self.earliest()
        start = max(now, self.free_at[i])
        end = start + duration
        self.free_at[i] = end
        return i, start, end


class SchedulerCore:
    """Shared lane pool, event heap, limiters and governor state.

    One core serves either a single store (the default) or every shard of
    a sharded store, in which case lane occupancy, job admission, dynamic
    GC thread allocation and GC bandwidth throttling are global across
    shards — the setting where the paper's scheduler (III-D) arbitrates
    between competing column families on one device.
    """

    def __init__(self, clock: Clock, device: BlockDevice, opts) -> None:
        self.clock = clock
        self.device = device
        self.opts = opts
        # The engine serialization point (see module docstring).  An RLock:
        # foreground ops, job bodies and event effects nest freely.
        self.engine_lock = threading.RLock()
        self.flush_lanes = Lanes(opts.flush_lanes)
        self.bg_lanes = Lanes(opts.n_threads)
        self.events: List[Tuple[float, int, Callable[[], None]]] = []
        self.counter = itertools.count()
        self.active = {JOB_FLUSH: 0, JOB_COMPACTION: 0, JOB_GC: 0,
                       JOB_MIGRATE: 0}
        self.max_gc = max(1, opts.n_threads // 2)   # TerarkDB static default
        # bandwidth governor state (paper III-D.2)
        self.gc_write_limiter = RateLimiter(clock, device.cost.write_bw)
        self.gc_read_limiter = RateLimiter(clock, device.cost.read_bw)
        device.gc_write_limiter = self.gc_write_limiter
        device.gc_read_limiter = self.gc_read_limiter
        self._pressures: Dict[int, Tuple[float, float]] = {}
        # Members re-offered admission whenever a job completes: with a
        # shared pool the lane a completion frees may be the one a
        # *different* shard's pending flush/compaction/GC is waiting for.
        self.waiters: List[Callable[[], None]] = []
        self._flush_bw_avg: Optional[float] = None
        self._win_start = 0.0
        self._win_flush_bytes = 0
        self._win_write_bytes = 0
        self._win_flush_time = 0.0
        # Observability: an active TraceRecorder (set by Store.trace())
        # sees job spans, commit rounds and governor decisions.
        self.tracer = None
        # Deterministic job ids (causal chains and trace args name the
        # blocking job as e.g. "compaction #412"), and the most recently
        # completed job: (kind, job_id, lane track, end time).  A stalled
        # writer reads the latter to learn *which* job's completion ended
        # its wait.
        self.job_seq = itertools.count(1)
        self.last_completed: Optional[Tuple[str, int, str, float]] = None
        # Monotonic core counters live in the device's metrics registry
        # so a crash/recovery cycle on the same device keeps them.
        # WAL commit accounting: a group commit is *one* charged sync
        # however many records it coalesces, and that is what the
        # bandwidth governor's write window sees (not N appends).
        self._wal = device.metrics.counters(
            "core/wal", {"syncs": 0, "records": 0, "bytes": 0})
        self._gov = device.metrics.counters(
            "core/governor", {"throttle_events": 0, "recoveries": 0})
        # Cumulative background write bytes per job kind (flush = every
        # byte the flush job wrote, kSSTs and vSSTs alike).  Unlike the
        # per-class device stats these are attributed by the *job* that
        # produced them, so the bench write-amp columns can read per-kind
        # background volume directly — and for a sharded store they
        # aggregate across every member of the core.  (The placement cost
        # model keeps its own per-store, index-only flush counter.)
        self.bg_write_bytes: Dict[str, int] = device.metrics.counters(
            "core/bg_write_bytes",
            {JOB_FLUSH: 0, JOB_COMPACTION: 0, JOB_GC: 0, JOB_MIGRATE: 0})

    # Legacy attribute names for the registry-backed counters.
    @property
    def wal_syncs(self) -> int:
        return self._wal["syncs"]

    @property
    def wal_records(self) -> int:
        return self._wal["records"]

    @property
    def wal_bytes(self) -> int:
        return self._wal["bytes"]

    @property
    def throttle_events(self) -> int:
        return self._gov["throttle_events"]

    # -- event pump ------------------------------------------------------
    def push_event(self, when: float, fn: Callable[[], None]) -> None:
        with self.engine_lock:
            heapq.heappush(self.events, (when, next(self.counter), fn))

    def add_waiter(self, fn: Callable[[], None]) -> None:
        self.waiters.append(fn)

    def notify_waiters(self) -> None:
        for fn in list(self.waiters):
            fn()

    def pump(self) -> bool:
        """Apply all effects due at or before the current clock."""
        with self.engine_lock:
            ran = False
            while self.events and self.events[0][0] <= self.clock.now:
                _, _, fn = heapq.heappop(self.events)
                fn()
                ran = True
            return ran

    def next_event_time(self) -> Optional[float]:
        with self.engine_lock:
            return self.events[0][0] if self.events else None

    def wait_for_event(self) -> bool:
        """Advance the clock to the next completion (used during stalls)."""
        with self.engine_lock:
            t = self.next_event_time()
            if t is None:
                return False
            self.clock.advance_to(t)
            self.pump()
            return True

    def drain(self, max_sim_s: float = 1e9) -> None:
        """Let all in-flight background work complete (quiesce)."""
        with self.engine_lock:
            guard = 0
            while self.wait_for_event():
                guard += 1
                if guard > 1_000_000 or self.clock.now > max_sim_s:
                    break

    # -- admission -------------------------------------------------------
    def can_admit(self, kind: str) -> bool:
        with self.engine_lock:
            if kind == JOB_FLUSH:
                return self.active[JOB_FLUSH] < self.opts.flush_lanes
            total = self.active[JOB_COMPACTION] + self.active[JOB_GC] \
                + self.active[JOB_MIGRATE]
            if total >= self.opts.n_threads:
                return False
            if kind == JOB_MIGRATE:
                # Migrations move one slot at a time and compete with
                # compaction/GC for the shared background lanes.
                return self.active[JOB_MIGRATE] < 1
            if kind == JOB_GC:
                return self.active[JOB_GC] < self.max_gc
            # Compaction may not claim the lanes reserved for GC: the
            # static baselines (Titan/TerarkDB) rely on ``max_gc`` lanes
            # staying available or value-store GC starves behind a
            # compaction backlog.  (Under the dynamic scheduler the same
            # bound applies with the governed, recomputed ``max_gc``.)
            return self.active[JOB_COMPACTION] < max(
                1, self.opts.n_threads - self.max_gc)

    # -- dynamic thread allocation (paper eq. 4-6) -------------------------
    def update_allocation(self, member: int, p_index: float,
                          p_value: float) -> None:
        """Record one member's pressures and recompute the global GC cap
        from the sum over members — a shard's value-store pressure claims
        lanes from the whole pool, not just its own slice."""
        if not self.opts.dynamic_scheduler:
            return
        with self.engine_lock:
            self._pressures[member] = (p_index, p_value)
            eps = 1e-6
            p_i = sum(max(p, 0.0) for p, _ in self._pressures.values()) + eps
            p_v = sum(max(p, 0.0) for _, p in self._pressures.values()) + eps
            n = self.opts.n_threads
            self.max_gc = int(round(n * p_v / (p_i + p_v)))
            self.max_gc = max(1, min(n - 1, self.max_gc))

    # -- bandwidth governor (paper III-D.2) --------------------------------
    def note_flush(self, nbytes: int, duration: float) -> None:
        with self.engine_lock:
            self._win_flush_bytes += nbytes
            self._win_flush_time += duration

    def note_write(self, nbytes: int) -> None:
        with self.engine_lock:
            self._win_write_bytes += nbytes

    def note_wal_sync(self, nbytes: int, nrecords: int = 1) -> None:
        """Record one durable WAL sync covering ``nrecords`` records."""
        with self.engine_lock:
            self._wal["syncs"] += 1
            self._wal["records"] += nrecords
            self._wal["bytes"] += nbytes
            self.note_write(nbytes)

    def note_bg_write(self, kind: str, nbytes: int) -> None:
        """Attribute ``nbytes`` of background output to job ``kind``."""
        with self.engine_lock:
            self.bg_write_bytes[kind] = \
                self.bg_write_bytes.get(kind, 0) + nbytes

    def wal_stats(self) -> Dict[str, int]:
        return {"syncs": self.wal_syncs, "records": self.wal_records,
                "bytes": self.wal_bytes}

    def bg_write_stats(self) -> Dict[str, int]:
        return dict(self.bg_write_bytes)

    def govern_bandwidth(self) -> None:
        if not self.opts.dynamic_scheduler:
            return
        with self.engine_lock:
            self._govern_locked()

    def _govern_locked(self) -> None:
        now = self.clock.now
        win = now - self._win_start
        if win < self.opts.rate_window_s:
            return
        write_util = self._win_write_bytes / (win * self.device.cost.write_bw)
        flush_bw = (self._win_flush_bytes / self._win_flush_time
                    if self._win_flush_time > 0 else None)
        if flush_bw is not None:
            if self._flush_bw_avg is None:
                self._flush_bw_avg = flush_bw
            else:
                self._flush_bw_avg = 0.8 * self._flush_bw_avg + 0.2 * flush_bw
        degraded = (flush_bw is not None and self._flush_bw_avg is not None
                    and flush_bw < 0.8 * self._flush_bw_avg)
        prev_frac = self.gc_write_limiter.fraction
        if write_util > 0.8 and degraded:
            self.gc_write_limiter.set_fraction(
                self.gc_write_limiter.fraction - self.opts.rate_limit_step)
            self.gc_read_limiter.set_fraction(
                self.gc_read_limiter.fraction - self.opts.rate_limit_step)
            self._gov["throttle_events"] += 1
            if self.tracer is not None:
                self.tracer.instant(
                    "governor", "throttle", now,
                    {"gc_bw_fraction": round(self.gc_write_limiter.fraction, 4),
                     "write_util": round(write_util, 4)})
        else:
            self.gc_write_limiter.set_fraction(
                min(1.0, self.gc_write_limiter.fraction + 0.05))
            self.gc_read_limiter.set_fraction(
                min(1.0, self.gc_read_limiter.fraction + 0.05))
            if self.gc_write_limiter.fraction > prev_frac:
                self._gov["recoveries"] += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "governor", "recover", now,
                        {"gc_bw_fraction":
                         round(self.gc_write_limiter.fraction, 4)})
        self._win_start = now
        self._win_flush_bytes = 0
        self._win_write_bytes = 0
        self._win_flush_time = 0.0


class Scheduler:
    """Per-store view over a (possibly shared) :class:`SchedulerCore`."""

    _member_ids = itertools.count()

    def __init__(self, clock: Clock, device: BlockDevice, opts,
                 core: Optional[SchedulerCore] = None) -> None:
        self.clock = clock
        self.device = device
        self.opts = opts
        self.core = core or SchedulerCore(clock, device, opts)
        self._member = next(Scheduler._member_ids)

    # ------------------------------------------------------------------
    def run_job(self, kind: str, body: Callable[[], Callable[[], None]],
                trace_args: Optional[Dict[str, object]] = None) -> float:
        """Execute ``body`` now (real work, time into a JobClock), schedule
        its returned effects at lane completion time.  Returns end time.

        The whole span runs under the engine lock: the JobClock redirects
        the *shared* clock's sink, so another thread charging time while
        the body runs would corrupt the job duration."""
        core = self.core
        with core.engine_lock:
            job_id = next(core.job_seq)
            core.active[kind] += 1
            # GC-class write bytes are attributed at the device to the
            # dynamically-scoped owner; a migration's copies must not be
            # booked as GC rewrite.
            bg_owner = JOB_MIGRATE if kind == JOB_MIGRATE else JOB_GC
            with self.device.attribute_gc_writes(bg_owner):
                with JobClock(self.device) as jc:
                    effects = body()
            lanes = core.flush_lanes if kind == JOB_FLUSH else core.bg_lanes
            lane, start, end = lanes.schedule(self.clock.now, jc.elapsed)
            elapsed = jc.elapsed
            track = (f"flush-lane-{lane}" if kind == JOB_FLUSH
                     else f"bg-lane-{lane}")
            if core.tracer is not None:
                args = dict(trace_args) if trace_args else {}
                args["job"] = job_id
                core.tracer.span(track, kind, start, end, args)
            causal = self.device.metrics.causal

            def _complete() -> None:
                core.active[kind] -= 1
                core.last_completed = (kind, job_id, track, end)
                # Effects may run inside a *foreground* op's pump: the op
                # pays for this job's bookkeeping I/O, so attribute those
                # charges to interference by this job.
                with self.device.attribute_gc_writes(bg_owner):
                    with causal.interference(kind, job_id):
                        effects(elapsed)
                core.notify_waiters()

            core.push_event(end, _complete)
            return end

    def pump(self) -> bool:
        return self.core.pump()

    def next_event_time(self) -> Optional[float]:
        return self.core.next_event_time()

    def wait_for_event(self) -> bool:
        return self.core.wait_for_event()

    def can_admit(self, kind: str) -> bool:
        return self.core.can_admit(kind)

    def update_allocation(self, p_index: float, p_value: float) -> None:
        self.core.update_allocation(self._member, p_index, p_value)

    def note_flush(self, nbytes: int, duration: float) -> None:
        self.core.note_flush(nbytes, duration)

    def note_write(self, nbytes: int) -> None:
        self.core.note_write(nbytes)

    def note_bg_write(self, kind: str, nbytes: int) -> None:
        self.core.note_bg_write(kind, nbytes)

    def govern_bandwidth(self) -> None:
        self.core.govern_bandwidth()

    # -- shared state passthroughs (read by stats/tests) ----------------
    @property
    def active(self) -> Dict[str, int]:
        return self.core.active

    @property
    def max_gc(self) -> int:
        return self.core.max_gc

    @property
    def gc_write_limiter(self) -> RateLimiter:
        return self.core.gc_write_limiter

    @property
    def gc_read_limiter(self) -> RateLimiter:
        return self.core.gc_read_limiter

    @property
    def throttle_events(self) -> int:
        return self.core.throttle_events

    @property
    def flush_lanes(self) -> Lanes:
        return self.core.flush_lanes

    @property
    def bg_lanes(self) -> Lanes:
        return self.core.bg_lanes
