"""Benchmark harness: drives op streams against any ``repro.core.Store``
(solo or sharded), measuring simulated throughput, space amplification
and the hidden/exposed garbage split via a user-level oracle (paper
Fig. 5/6 decomposition).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional

from ..core.db import KVStore
from ..core.options import preset
from ..core.sharded import ShardedKVStore
from ..obs import Histogram
from ..obs import runtime as obs_runtime
from ..store.format import VT_VALUE
from .workloads import KEY_BYTES, Op, ScaleConfig, WorkloadSpec


class Oracle:
    """Tracks the true user dataset so the benchmark can split engine
    'live' bytes into valid data D and hidden garbage G_H (eq. 3).

    * logical_bytes: Σ (key + current value) — space-amp denominator;
    * sep_bytes: Σ current value sizes above the separation threshold —
      the engine's value-store live bytes minus this = hidden garbage.
    """

    def __init__(self, sep_threshold: int) -> None:
        self.sep_threshold = sep_threshold
        self._sizes: Dict[bytes, int] = {}
        self.logical_bytes = 0
        self.sep_bytes = 0

    def on_write(self, ukey: bytes, vtype: int, payload: bytes) -> None:
        old = self._sizes.pop(ukey, None)
        if old is not None:
            self.logical_bytes -= old + KEY_BYTES
            if old >= self.sep_threshold:
                self.sep_bytes -= old
        if vtype == VT_VALUE:
            self._sizes[ukey] = len(payload)
            self.logical_bytes += len(payload) + KEY_BYTES
            if len(payload) >= self.sep_threshold:
                self.sep_bytes += len(payload)

    def garbage_split(self, db: KVStore) -> Dict[str, float]:
        tot, live = db.versions.value_stats()
        exposed = tot - live
        hidden = max(0, live - self.sep_bytes)
        d = max(1, self.sep_bytes)
        return {"exposed_bytes": exposed, "hidden_bytes": hidden,
                "exposed_over_d": exposed / d, "hidden_over_d": hidden / d}


@dataclasses.dataclass
class PhaseResult:
    name: str
    ops: int
    sim_seconds: float
    wall_seconds: float
    kops_per_s: float
    io_read_bytes: int
    io_write_bytes: int
    p50_us: float = 0.0
    p95_us: float = 0.0
    p99_us: float = 0.0
    p999_us: float = 0.0
    wal_syncs: int = 0

    @property
    def wal_syncs_per_op(self) -> float:
        """Device syncs charged for WAL durability per operation: ≈1.0
        for per-op commits, ≈1/batch under group commit."""
        return self.wal_syncs / max(1, self.ops)

    def row(self) -> str:
        us = 1e6 * self.sim_seconds / max(1, self.ops)
        return f"{self.name},{us:.2f},{self.kops_per_s:.2f}kops/s"


def wal_sync_count(db) -> int:
    """Cumulative WAL syncs for a KVStore or ShardedKVStore (the counter
    lives on the scheduler core, which shards share)."""
    core = getattr(db, "sched_core", None)
    if core is None:
        core = db.sched.core
    return core.wal_syncs


def make_db(system: str, spec: WorkloadSpec,
            space_limit_x: Optional[float] = None, n_shards: int = 0,
            **over):
    """Build a KVStore (default) or, with ``n_shards >= 1``, a
    ShardedKVStore for the given system preset, workload-scaled.  The
    space cap is enforced on the shared device, so it stays a *global*
    budget regardless of shard count."""
    opts = preset(system, **over)
    ScaleConfig(spec.dataset_bytes).apply(opts)
    if space_limit_x is not None:
        opts.space_cap_bytes = int(space_limit_x * spec.dataset_bytes)
    db = (ShardedKVStore(opts, n_shards=n_shards) if n_shards
          else KVStore(opts))
    oracle = Oracle(opts.sep_threshold)
    db.on_user_write = oracle.on_write
    db.oracle = oracle  # type: ignore[attr-defined]
    # No-op unless benchmarks/run.py was given --trace/--metrics-json.
    obs_runtime.attach(db, system)
    return db


def run_phase(db, name: str, ops: Iterable[Op],
              drain: bool = False,
              capture_latency: bool = False,
              batch: int = 0) -> PhaseResult:
    """Drive an op stream.  With ``batch > 1``, consecutive writes
    coalesce into ``write_batch`` and consecutive gets into ``multi_get``
    (batch latency attributed evenly across its ops); stores without the
    batched API fall back to per-op submission.  ``('rmw', k, v)`` ops
    (YCSB-F) go through ``db.read_modify_write`` individually — the
    read-validate-write round trip is the thing being measured."""
    if batch > 1 and not hasattr(db, "write_batch"):
        batch = 0
    st = db.device.stats
    r0 = st.read_bytes()
    w0 = st.write_bytes()
    s0 = wal_sync_count(db)
    t0 = db.clock.now
    wall0 = time.perf_counter()
    n = 0
    # Latency percentiles come from a log-bucketed repro.obs Histogram
    # (upper-edge estimates, <=19% relative error) instead of a sorted
    # list — same machinery that backs Store.metrics().
    hist = Histogram() if capture_latency else None

    wbuf: list = []         # pending ('put'|'del', ...) ops
    gbuf: list = []         # pending get keys

    def _flush_writes() -> None:
        if not wbuf:
            return
        b_t0 = db.clock.now
        db.write_batch(wbuf)
        if hist is not None:
            hist.record_n((db.clock.now - b_t0) / len(wbuf), len(wbuf))
        wbuf.clear()

    def _flush_gets() -> None:
        if not gbuf:
            return
        b_t0 = db.clock.now
        db.multi_get(gbuf)
        if hist is not None:
            hist.record_n((db.clock.now - b_t0) / len(gbuf), len(gbuf))
        gbuf.clear()

    for op in ops:
        kind = op[0]
        if batch > 1:
            if kind in ("put", "del"):
                _flush_gets()
                wbuf.append(op)
                if len(wbuf) >= batch:
                    _flush_writes()
            elif kind == "get":
                _flush_writes()
                gbuf.append(op[1])
                if len(gbuf) >= batch:
                    _flush_gets()
            elif kind == "rmw":
                _flush_writes()
                _flush_gets()
                s_t0 = db.clock.now
                db.read_modify_write(op[1], lambda _cur, v=op[2]: v)
                if hist is not None:
                    hist.record(db.clock.now - s_t0)
            else:
                _flush_writes()
                _flush_gets()
                s_t0 = db.clock.now
                db.scan(op[1], op[2])
                if hist is not None:
                    hist.record(db.clock.now - s_t0)
            n += 1
            continue
        if hist is not None:
            op_t0 = db.clock.now
        if kind == "put":
            db.put(op[1], op[2])
        elif kind == "get":
            db.get(op[1])
        elif kind == "del":
            db.delete(op[1])
        elif kind == "rmw":
            db.read_modify_write(op[1], lambda _cur, v=op[2]: v)
        else:
            db.scan(op[1], op[2])
        if hist is not None:
            hist.record(db.clock.now - op_t0)
        n += 1
    if batch > 1:
        _flush_writes()
        _flush_gets()
    if drain:
        db.drain()
    sim = db.clock.now - t0
    wall = time.perf_counter() - wall0
    res = PhaseResult(name=name, ops=n, sim_seconds=sim, wall_seconds=wall,
                      kops_per_s=n / max(sim, 1e-12) / 1e3,
                      io_read_bytes=st.read_bytes() - r0,
                      io_write_bytes=st.write_bytes() - w0,
                      wal_syncs=wal_sync_count(db) - s0)
    if hist is not None and hist.count:
        res.p50_us = 1e6 * hist.percentile(50)
        res.p95_us = 1e6 * hist.percentile(95)
        res.p99_us = 1e6 * hist.percentile(99)
        res.p999_us = 1e6 * hist.percentile(99.9)
    return res


def space_amplification(db) -> float:
    oracle = getattr(db, "oracle", None)
    logical = oracle.logical_bytes if oracle else 1
    return db.device.total_bytes() / max(1, logical)
