"""Continuous invariant auditor over metrics snapshots.

The observability layer accounts the same bytes twice on purpose: once
at the device (per-:class:`IOClass` totals) and once at the engine
(write-amp sources, space components, cache quotas).  Those views must
agree *exactly* — every table writer appends its whole file in one
device call, background write classes are attributed centrally at the
device, and space components are derived from live file metadata — so
any drift between them is an accounting bug, not noise.

:func:`audit_snapshot` re-checks the conservation laws on a metrics
snapshot (the dict returned by ``KVStore.metrics()`` /
``ShardedKVStore.metrics()``) and returns structured
:class:`AuditViolation` records instead of silently drifting:

* ``wal-bytes`` / ``flush-bytes`` / ``compaction-bytes`` /
  ``gc-bytes`` — each write-amp source equals the device bytes of its
  I/O class(es);
* ``write-sources-total`` — the sources sum to the device's logged
  write traffic (the headline "write-amp sources sum to device
  writes");
* ``space-components`` — index + value-file + other bytes equal the
  device footprint exactly, and garbage never exceeds value bytes;
* ``cache-quota`` — per-shard cache quotas sum exactly to the budget;
* ``ledger-monotone`` — windowed ledger samples have non-decreasing
  timestamps and non-negative per-window deltas;
* ``stall-split`` — the per-cause stall counters sum to total stall
  time;
* ``histogram`` — bucket counts sum to the total count and
  p50 <= p95 <= p99;
* ``exemplar-shares`` — every causal exemplar's attribution shares sum
  to its measured latency within 1 %.

Byte rules use an absolute tolerance of half a byte (the counters are
integers; any real divergence trips them), time rules a relative 1e-6
(float accumulation order).

CLI (used by the CI bench-smoke job)::

    python -m repro.obs.audit METRICS.json [...]

accepts both a single snapshot and a ``{label: snapshot}`` dump (the
``--metrics-json`` artifact written by ``benchmarks.run``); exits
non-zero if any file yields violations.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: write-amp source -> device I/O classes whose bytes it must equal
SOURCE_CLASSES = {
    "wal": ("wal",),
    "flush": ("flush",),
    "compaction": ("compaction_write",),
    "gc": ("gc_write", "gc_write_index"),
}

_BYTE_TOL = 0.5
_REL_TOL = 1e-6
_SHARE_TOL = 0.01  # exemplar shares must sum within 1% of latency


@dataclass
class AuditViolation:
    """One violated conservation law."""

    rule: str
    detail: str
    expected: float
    actual: float
    label: str = ""

    def __str__(self) -> str:
        where = f"[{self.label}] " if self.label else ""
        return (f"{where}{self.rule}: {self.detail} "
                f"(expected {self.expected!r}, actual {self.actual!r})")


@dataclass
class AuditReport:
    violations: List[AuditViolation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def _add(self, rule: str, detail: str, expected: float,
             actual: float, label: str = "") -> None:
        self.violations.append(
            AuditViolation(rule, detail, expected, actual, label))


def _close(a: float, b: float, *, rel: float = _REL_TOL,
           abs_tol: float = 0.0) -> bool:
    return abs(a - b) <= max(abs_tol, rel * max(abs(a), abs(b)))


def _io_bytes(io: Dict[str, dict], *classes: str) -> float:
    return sum(io.get(c, {}).get("bytes", 0) for c in classes)


def _audit_write_sources(rep: AuditReport, snap: dict, label: str) -> None:
    io = snap.get("io")
    amp = snap.get("amp")
    if io is None or amp is None:
        return
    sources = amp.get("write_bytes", {})
    total = 0.0
    io_total = 0.0
    for src, classes in SOURCE_CLASSES.items():
        want = _io_bytes(io, *classes)
        got = sources.get(src, 0) + (sources.get("migration", 0)
                                     if src == "gc" else 0)
        total += got
        io_total += want
        if not _close(got, want, abs_tol=_BYTE_TOL):
            rep._add(f"{src}-bytes",
                     f"source {src!r} diverges from device classes "
                     f"{'+'.join(classes)}", want, got, label)
    if not _close(total, io_total, abs_tol=_BYTE_TOL):
        rep._add("write-sources-total",
                 "write-amp sources do not sum to logged device writes",
                 io_total, total, label)


def _audit_space(rep: AuditReport, snap: dict, label: str) -> None:
    space = snap.get("amp", {}).get("space")
    if not space:
        return
    total = space.get("device_total_bytes", 0)
    parts = (space.get("index_bytes", 0) + space.get("value_file_bytes", 0)
             + space.get("other_bytes", 0))
    if not _close(parts, total, abs_tol=_BYTE_TOL):
        rep._add("space-components",
                 "index + value_file + other != device footprint",
                 total, parts, label)
    for k in ("index_bytes", "value_file_bytes", "other_bytes",
              "value_live_bytes", "value_garbage_bytes"):
        v = space.get(k, 0)
        if v < 0:
            rep._add("space-components", f"negative component {k!r}", 0, v,
                     label)
    if space.get("value_garbage_bytes", 0) - space.get(
            "value_file_bytes", 0) > _BYTE_TOL:
        rep._add("space-components",
                 "value garbage exceeds value-file bytes",
                 space.get("value_file_bytes", 0),
                 space.get("value_garbage_bytes", 0), label)


def _audit_cache(rep: AuditReport, snap: dict, label: str) -> None:
    cache = snap.get("cache")
    if not cache:
        return
    cap = cache.get("capacity_bytes", 0)
    qsum = cache.get("quota_sum_bytes", 0)
    if qsum != cap:
        rep._add("cache-quota", "shard quotas do not sum to cache budget",
                 cap, qsum, label)
    quotas = cache.get("quota_bytes") or []
    if quotas and sum(quotas) != qsum:
        rep._add("cache-quota", "per-shard quota list disagrees with sum",
                 qsum, sum(quotas), label)


def _audit_ledger_series(rep: AuditReport, snap: dict, label: str) -> None:
    series = snap.get("amp", {}).get("series")
    if not series:
        return
    prev_t = None
    for i, win in enumerate(series):
        t = win.get("t", 0.0)
        if prev_t is not None and t < prev_t:
            rep._add("ledger-monotone",
                     f"window {i} timestamp regressed", prev_t, t, label)
        prev_t = t
        if win.get("user_bytes", 0) < 0:
            rep._add("ledger-monotone",
                     f"window {i} negative user bytes delta", 0,
                     win.get("user_bytes", 0), label)
        for group in ("writes", "space"):
            for k, v in (win.get(group) or {}).items():
                if group == "writes" and v < 0:
                    rep._add("ledger-monotone",
                             f"window {i} negative {group}[{k}] delta",
                             0, v, label)


def _audit_stalls(rep: AuditReport, snap: dict, label: str) -> None:
    counters = snap.get("registry", {}).get("counters", {})
    for name, group in counters.items():
        if "stall_time_s" not in group:
            continue
        split = sum(v for k, v in group.items()
                    if k.startswith("stall_") and k.endswith("_s")
                    and k != "stall_time_s")
        total = group["stall_time_s"]
        if not _close(split, total, abs_tol=1e-12):
            rep._add("stall-split",
                     f"{name}: per-cause stalls do not sum to total",
                     total, split, label)


def _audit_histograms(rep: AuditReport, snap: dict, label: str) -> None:
    hists = snap.get("registry", {}).get("histograms", {})
    for name, h in hists.items():
        bucket_sum = sum((h.get("buckets") or {}).values())
        if bucket_sum != h.get("count", 0):
            rep._add("histogram", f"{name}: bucket counts != count",
                     h.get("count", 0), bucket_sum, label)
        p50, p95, p99 = h.get("p50", 0), h.get("p95", 0), h.get("p99", 0)
        if not (p50 <= p95 + 1e-15 and p95 <= p99 + 1e-15):
            rep._add("histogram", f"{name}: percentiles not monotone",
                     p50, p99, label)
        if h.get("count", 0) and h.get("sum", 0.0) < 0:
            rep._add("histogram", f"{name}: negative sum", 0,
                     h.get("sum", 0.0), label)


def _audit_exemplars(rep: AuditReport, snap: dict, label: str) -> None:
    exemplars = snap.get("registry", {}).get("exemplars", {})
    for name, buckets in exemplars.items():
        for bucket, recs in buckets.items():
            for rec in recs:
                lat = rec.get("latency_s", 0.0)
                share_sum = sum((rec.get("shares") or {}).values())
                if abs(share_sum - lat) > max(_SHARE_TOL * lat, 1e-12):
                    rep._add("exemplar-shares",
                             f"{name}[{bucket}] op={rec.get('op')} "
                             f"seq={rec.get('seq')}: shares do not sum "
                             f"to latency", lat, share_sum, label)
                if lat < 0:
                    rep._add("exemplar-shares",
                             f"{name}[{bucket}]: negative latency", 0,
                             lat, label)


_RULES = (_audit_write_sources, _audit_space, _audit_cache,
          _audit_ledger_series, _audit_stalls, _audit_histograms,
          _audit_exemplars)


def audit_snapshot(snap: dict, label: str = "",
                   report: Optional[AuditReport] = None) -> AuditReport:
    """Audit one ``metrics()`` snapshot; returns the (shared) report."""
    rep = report if report is not None else AuditReport()
    for rule in _RULES:
        rule(rep, snap, label)
    return rep


def audit_document(doc: dict, report: Optional[AuditReport] = None
                   ) -> AuditReport:
    """Audit a metrics JSON document: either a single snapshot or a
    ``{label: snapshot}`` mapping (the benchmark ``--metrics-json``
    artifact)."""
    rep = report if report is not None else AuditReport()
    if "registry" in doc or "amp" in doc:
        return audit_snapshot(doc, report=rep)
    for label in sorted(doc):
        snap = doc[label]
        if isinstance(snap, dict):
            audit_snapshot(snap, label=label, report=rep)
    return rep


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro.obs.audit METRICS.json [...]",
              file=sys.stderr)
        return 2
    failed = False
    for path in argv:
        with open(path) as f:
            doc = json.load(f)
        rep = audit_document(doc)
        if rep.ok:
            print(f"{path}: OK (all conservation laws hold)")
        else:
            failed = True
            print(f"{path}: {len(rep.violations)} violation(s)")
            for v in rep.violations:
                print(f"  {v}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["AuditViolation", "AuditReport", "audit_snapshot",
           "audit_document", "main", "SOURCE_CLASSES"]
