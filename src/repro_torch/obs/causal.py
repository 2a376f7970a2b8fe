"""Request-scoped causal tracing and tail-latency attribution.

A :class:`CausalTracer` (one per :class:`~.registry.MetricsRegistry`,
i.e. one per device) carries a thread-local stack of per-op
:class:`OpContext` records.  The foreground paths open a context for a
*sampled* op (every ``sample_every``-th op per shard, deterministic on
the per-shard op counter), and every simulated-time charge that lands
inside the op's span attributes itself to a named **share**:

* ``cpu`` — engine CPU charges (``BlockDevice.charge_cpu``);
* ``wal_sync`` — WAL-class device appends (the commit round the op
  itself paid for);
* ``device_read`` / ``device_write`` — other foreground device I/O,
  with read hops also appended to the causal **chain**;
* ``stall_<cause>`` — admission stalls, charged explicitly by the
  write path with the *blocking job's* kind and id in the chain;
* ``slowdown`` — the soft write-controller delay;
* ``interference_<kind>`` — background-job *effects* that ran inside
  the op's event pump (the op paid for another job's bookkeeping);
* ``other`` — the residual, so shares always sum to the measured
  latency.

Two charge *modes* keep the decomposition double-count free:

* **absorb** (:meth:`CausalTracer.absorb`) — active while the op waits
  in a stall loop: the clock jumps and pumped effects charge device
  time, but the write path charges the whole wait to ``stall_<cause>``
  once, so per-I/O charges inside the window are swallowed.
* **interference** (:meth:`CausalTracer.interference`) — active while
  a completed job's effects run inside a foreground pump: charges land
  in ``interference_<kind>`` instead of the plain device shares.

Sampled ops finish into **exemplar** records attached to their latency
histogram's bucket (capped per bucket), so a report can answer "p99
puts: 71% stall_l0 behind compaction #412" from a metrics snapshot.
Exemplars carry *no wall-clock data and no absolute timestamps*, so
``metrics(sim_only=True)`` stays byte-identical across same-seed runs.

Ops that finish inside an open commit group park until the next commit
round publishes, so their chain carries the round (csn, coalesced
record count) with a ``follower`` role; write-through ops see their
round inline with a ``leader`` role.

This module is dependency-free within the repo (``repro.store`` and
``repro.core`` import *it*); I/O classes arrive as plain strings.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

#: Chain links kept per op (device hops, stalls, commit round, ...).
MAX_CHAIN = 12
#: Exemplar records kept per histogram bucket.
MAX_PER_BUCKET = 4


class OpContext:
    """One sampled foreground op's attribution state."""

    __slots__ = ("op", "shard", "seq", "shares", "chain", "absorb_depth",
                 "interf", "round_seen", "_last_interf_job")

    def __init__(self, op: str, shard: int, seq: int) -> None:
        self.op = op
        self.shard = shard
        self.seq = seq
        self.shares: Dict[str, float] = {}
        self.chain: List[dict] = []
        self.absorb_depth = 0
        self.interf: Optional[Tuple[str, int]] = None
        self.round_seen = False
        self._last_interf_job: Optional[int] = None

    def add_share(self, name: str, dt: float) -> None:
        if dt > 0.0:
            self.shares[name] = self.shares.get(name, 0.0) + dt

    def add_link(self, link: dict) -> None:
        if len(self.chain) < MAX_CHAIN:
            self.chain.append(link)


class CausalTracer:
    """Per-registry causal/attribution engine (see module docstring).

    All mutating entry points run under the engine lock (foreground ops
    hold it for their whole span; commit drains and job effects run
    inside it), so the per-shard counters, the parked list and the
    exemplar store need no locking of their own.  The only cross-thread
    state is the thread-local context stack.
    """

    def __init__(self) -> None:
        self.sample_every = 64
        #: Histogram bucketing function, injected by the registry so this
        #: module stays import-free (exemplar buckets must align with
        #: Histogram buckets).
        self.bucket_fn: Optional[Callable[[float], int]] = None
        #: Open sampled contexts across all threads — a cheap gate for
        #: the device's per-I/O hook.
        self.depth = 0
        self._op_counts: Dict[int, int] = {}
        self._tls = threading.local()
        # hist name -> bucket index -> [exemplar records]
        self.exemplars: Dict[str, Dict[int, List[dict]]] = {}
        # finished-but-unrounded ops awaiting their commit round
        self._parked: List[Tuple[str, int, dict]] = []

    # -- context lifecycle --------------------------------------------
    def current(self) -> Optional[OpContext]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def start(self, op: str, shard: int) -> Optional[OpContext]:
        """Open a context for one foreground op iff it is sampled.
        Always advances the shard's deterministic op counter."""
        n = self._op_counts.get(shard, 0)
        self._op_counts[shard] = n + 1
        if n % self.sample_every:
            return None
        ctx = OpContext(op, shard, n)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(ctx)
        self.depth += 1
        return ctx

    def finish(self, ctx: OpContext, hist_name: str, latency: float, *,
               defer: bool = False, tracer=None,
               t0: Optional[float] = None) -> dict:
        """Close a sampled op: fold the residual into ``other``, emit the
        op span (when tracing), and store — or park, when the op's commit
        round has not published yet — the exemplar record."""
        self._tls.stack.pop()
        self.depth -= 1
        resid = latency - sum(ctx.shares.values())
        if resid > 0.0:
            ctx.add_share("other", resid)
        rec = {"op": ctx.op, "shard": ctx.shard, "seq": ctx.seq,
               "latency_s": latency, "shares": ctx.shares,
               "chain": ctx.chain}
        bucket = self.bucket_fn(latency) if self.bucket_fn is not None else 0
        if tracer is not None and t0 is not None:
            tracer.complete(f"op/shard{ctx.shard}", ctx.op, t0, latency,
                            {"seq": ctx.seq})
        if defer and not ctx.round_seen:
            self._parked.append((hist_name, bucket, rec))
        else:
            self._store(hist_name, bucket, rec)
        return rec

    def _store(self, hist_name: str, bucket: int, rec: dict) -> None:
        buckets = self.exemplars.setdefault(hist_name, {})
        recs = buckets.setdefault(bucket, [])
        if len(recs) < MAX_PER_BUCKET:
            recs.append(rec)

    # -- charge modes -------------------------------------------------
    @contextmanager
    def absorb(self):
        """Swallow per-I/O charges (the caller charges the whole window
        to a stall share itself)."""
        ctx = self.current()
        if ctx is not None:
            ctx.absorb_depth += 1
        try:
            yield
        finally:
            if ctx is not None:
                ctx.absorb_depth -= 1

    @contextmanager
    def interference(self, kind: str, job_id: int):
        """Attribute charges inside the window to background job
        ``kind`` #``job_id`` (a completed job's effects running inside
        the op's pump)."""
        ctx = self.current()
        prev = None
        if ctx is not None:
            prev = ctx.interf
            ctx.interf = (kind, job_id)
        try:
            yield
        finally:
            if ctx is not None:
                ctx.interf = prev

    # -- charge hooks -------------------------------------------------
    def on_io(self, cls_name: str, is_write: bool, nbytes: int,
              dt: float, fid: int) -> None:
        """One charged foreground device I/O (called by the device when a
        context is open and the clock actually advanced)."""
        ctx = self.current()
        if ctx is None or ctx.absorb_depth:
            return
        if ctx.interf is not None:
            kind, job = ctx.interf
            ctx.add_share(f"interference_{kind}", dt)
            if ctx._last_interf_job != job:
                ctx._last_interf_job = job
                ctx.add_link({"kind": "interference", "job_kind": kind,
                              "job": job})
            return
        if not is_write:
            ctx.add_share("device_read", dt)
            ctx.add_link({"kind": "device_hop", "cls": cls_name,
                          "bytes": nbytes, "fid": fid})
        elif cls_name == "wal":
            ctx.add_share("wal_sync", dt)
        else:
            ctx.add_share("device_write", dt)

    def on_cpu(self, dt: float) -> None:
        ctx = self.current()
        if ctx is None or ctx.absorb_depth:
            return
        if ctx.interf is not None:
            ctx.add_share(f"interference_{ctx.interf[0]}", dt)
            return
        ctx.add_share("cpu", dt)

    def charge_named(self, name: str, dt: float) -> None:
        """Explicit share charge on the current context (slowdown etc.)."""
        ctx = self.current()
        if ctx is not None:
            ctx.add_share(name, dt)

    def charge_stall(self, cause: str, dt: float, *,
                     by_kind: Optional[str] = None,
                     by_job: Optional[int] = None) -> None:
        """One stall-loop wait: the whole window to ``stall_<cause>``,
        with the job whose completion ended the wait in the chain."""
        ctx = self.current()
        if ctx is None:
            return
        ctx.add_share(f"stall_{cause}", dt)
        ctx.add_link({"kind": "stall", "cause": cause,
                      "by_kind": by_kind, "by_job": by_job})

    def note_cache_miss(self, sid: int) -> None:
        """A read-cache miss inside the op (the device hop that follows
        is charged separately by :meth:`on_io`)."""
        ctx = self.current()
        if ctx is None or ctx.absorb_depth or ctx.interf is not None:
            return
        ctx.add_link({"kind": "cache_miss", "shard": sid})

    def commit_round(self, csn: int, records: int, nbytes: int) -> None:
        """A WAL commit round published: link it to the draining thread's
        own context (it led the round) and to every parked op the round
        covers (they rode it as followers), releasing their exemplars."""
        ctx = self.current()
        if ctx is not None and not ctx.round_seen:
            ctx.round_seen = True
            ctx.add_link({"kind": "commit_round", "csn": csn,
                          "role": "leader", "records": records,
                          "bytes": nbytes})
        if self._parked:
            for hist_name, bucket, rec in self._parked:
                chain = rec["chain"]
                if len(chain) < MAX_CHAIN:
                    chain.append({"kind": "commit_round", "csn": csn,
                                  "role": "follower", "records": records,
                                  "bytes": nbytes})
                self._store(hist_name, bucket, rec)
            self._parked.clear()

    # -- snapshots ----------------------------------------------------
    def snapshot(self, names: Optional[List[str]] = None
                 ) -> Dict[str, Dict[str, List[dict]]]:
        """Exemplars as JSON-ready nested dicts; ``names`` (when given)
        restricts to those histogram names (the registry passes its
        ``sim_only``-filtered list)."""
        allowed = None if names is None else set(names)
        out: Dict[str, Dict[str, List[dict]]] = {}
        for name in sorted(self.exemplars):
            if allowed is not None and name not in allowed:
                continue
            buckets = self.exemplars[name]
            out[name] = {str(i): list(buckets[i]) for i in sorted(buckets)}
        return out


__all__ = ["CausalTracer", "OpContext", "MAX_CHAIN", "MAX_PER_BUCKET"]
