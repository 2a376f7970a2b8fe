"""Unified observability layer.

Four pieces (see ROADMAP "Observability"):

* :class:`MetricsRegistry` — typed counter groups and log-bucketed
  latency histograms behind a hierarchical, per-shard-labeled
  namespace.  The engines' ``stats_counters`` dicts are *views* onto
  registry groups, so the legacy ``stats()`` keys keep working while
  every counter survives a crash/recovery cycle (the registry lives on
  the shared :class:`~repro.store.device.BlockDevice`).
* :class:`AmplificationLedger` — write-amp by source (WAL, flush,
  compaction, GC rewrite, migration copy) and space-amp by component
  (index LSM, live values, dead garbage, filter overhead), with a
  windowed time series sampled on the simulated clock.
* :class:`TraceRecorder` — Chrome trace-event JSON (Perfetto-loadable):
  background jobs as duration spans on per-lane tracks, commit-group
  rounds, device I/O by ``IOClass``, governor / placement-retune /
  rebalancer decisions as instant events, and causal flow arrows from
  blocking background jobs to the foreground ops they delayed.
* :class:`CausalTracer` — request-scoped causal tracing and
  tail-latency attribution: sampled per-op contexts decompose latency
  into named shares (wal-sync, stall-by-cause, device-read, cpu,
  interference) and record exemplars on histogram buckets with the
  causal chain (commit round, blocking job, cache-miss device hops).
* :func:`audit_snapshot` — continuous invariant auditor: re-checks
  conservation laws (write-amp sources == device writes, space
  components == device footprint, cache quotas == budget, monotone
  ledger windows, exemplar shares == latency) on every metrics
  snapshot, returning structured :class:`AuditViolation` reports.
* CLIs — ``python -m repro.obs.report`` (text dashboard from a metrics
  snapshot, including p99 attribution), ``python -m repro.obs.lint``
  (trace validity lint incl. flow pairing and op-track nesting) and
  ``python -m repro.obs.audit`` (invariant audit over metrics JSON).

This package is dependency-free within the repo: ``repro.store`` and
``repro.core`` import *it*, never the other way round.
"""

from .audit import AuditReport, AuditViolation, audit_document, audit_snapshot
from .causal import CausalTracer, OpContext
from .ledger import AmplificationLedger
from .registry import CounterGroup, Histogram, MetricsRegistry
from .trace import TraceRecorder, lint_events

__all__ = [
    "AmplificationLedger",
    "AuditReport",
    "AuditViolation",
    "CausalTracer",
    "CounterGroup",
    "Histogram",
    "MetricsRegistry",
    "OpContext",
    "TraceRecorder",
    "audit_document",
    "audit_snapshot",
    "lint_events",
]
