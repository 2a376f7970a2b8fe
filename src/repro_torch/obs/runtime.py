"""Bench-harness plumbing for the observability layer.

``benchmarks/run.py`` calls :func:`configure` with the ``--trace=`` /
``--metrics-json=`` paths before running suites; ``make_db`` calls
:func:`attach` for every store it builds; :func:`flush` at the end
writes one merged trace (each store a separate trace "process") and
one ``{label: metrics}`` JSON.  With neither flag set every call here
is a cheap no-op, so benches pay nothing by default.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from .trace import TraceRecorder

_trace_path: Optional[str] = None
_metrics_path: Optional[str] = None
_dbs: List[Tuple[str, object]] = []
_recorders: List[TraceRecorder] = []
# Every store built since the last take_sim_time() call, tracked even
# when no sink is configured — the bench harness sums simulated time
# per suite for its BENCH_<suite>.json trajectory records.
_sim_dbs: List[object] = []


def configure(trace: Optional[str] = None,
              metrics: Optional[str] = None) -> None:
    global _trace_path, _metrics_path
    _trace_path = trace
    _metrics_path = metrics
    _dbs.clear()
    _recorders.clear()


def active() -> bool:
    return bool(_trace_path or _metrics_path)


def take_sim_time() -> float:
    """Total simulated seconds across stores built since the last call
    (each store's clock ends at its total simulated runtime)."""
    global _sim_dbs
    total = sum(db.clock.now for db in _sim_dbs)
    _sim_dbs = []
    return total


def attach(db, label: str) -> None:
    """Register a freshly built store with the configured sinks."""
    _sim_dbs.append(db)
    if not active():
        return
    label = f"{label}#{len(_dbs)}"
    _dbs.append((label, db))
    if _metrics_path:
        db.obs.sampling = True
    if _trace_path:
        rec = TraceRecorder(db.clock, pid=len(_recorders) + 1,
                            process_name=label)
        db.start_trace(rec)
        _recorders.append(rec)


def flush() -> List[str]:
    """Write the configured sinks; returns the paths written."""
    written: List[str] = []
    if _metrics_path:
        out = {label: db.metrics() for label, db in _dbs}
        with open(_metrics_path, "w") as f:
            json.dump(out, f, indent=1)
        written.append(_metrics_path)
    if _trace_path:
        events: List[dict] = []
        # Per-recorder sorted blocks concatenate safely: tracks are
        # namespaced by pid, so per-(pid, tid) monotonicity holds even
        # though different stores' clocks are unrelated.
        for rec in _recorders:
            events.extend(rec.sorted_events())
        with open(_trace_path, "w") as f:
            json.dump({"traceEvents": events}, f)
        written.append(_trace_path)
    _dbs.clear()
    _recorders.clear()
    return written


__all__ = ["configure", "active", "attach", "flush", "take_sim_time"]
