"""Text dashboard CLI: ``python -m repro.obs.report metrics.json``.

Accepts either a single ``Store.metrics()`` snapshot or the
``{label: snapshot, ...}`` mapping written by
``benchmarks/run.py --metrics-json=``.
"""

from __future__ import annotations

import json
import sys
from typing import Dict


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TB"


def _fmt_us(s: float) -> str:
    return f"{s * 1e6:.1f}us"


def _tail_exemplar(hist: Dict, buckets: Dict) -> Dict:
    """The exemplar record that best represents the histogram's p99:
    closest latency at-or-above p99, falling back to closest below."""
    p99 = hist.get("p99", 0.0)
    best_key, best = None, None
    for recs in buckets.values():
        for rec in recs:
            lat = rec.get("latency_s", 0.0)
            key = (0 if lat >= p99 else 1, abs(lat - p99))
            if best_key is None or key < best_key:
                best_key, best = key, rec
    return best


def _blame(share: str, chain) -> str:
    """Human tail for an attribution row: which background job (or
    commit round / device hops) the dominant share sits behind."""
    if share.startswith("stall_"):
        for link in chain:
            if link.get("kind") == "stall" and link.get("by_kind"):
                return f"behind {link['by_kind']} #{link['by_job']}"
        return ""
    if share.startswith("interference_"):
        for link in chain:
            if link.get("kind") == "interference":
                return f"behind {link['job_kind']} #{link['job']}"
        return ""
    if share == "device_read":
        hops = sum(1 for link in chain if link.get("kind") == "device_hop")
        return f"({hops} device hop{'s' if hops != 1 else ''})"
    if share == "wal_sync":
        for link in chain:
            if link.get("kind") == "commit_round":
                return (f"commit round csn={link['csn']} "
                        f"({link['role']}, {link['records']} recs)")
    return ""


def render_attribution(reg: Dict, w) -> None:
    """Per-histogram p99 attribution from sampled causal exemplars:
    ``p99 shard0/put: 71% stall_l0 behind compaction #412``."""
    exemplars = reg.get("exemplars") or {}
    hists = reg.get("histograms", {})
    rows = []
    for name in sorted(exemplars):
        hist = hists.get(name)
        if not hist or not hist.get("count"):
            continue
        rec = _tail_exemplar(hist, exemplars[name])
        if rec is None or not rec.get("shares"):
            continue
        share, dt = max(rec["shares"].items(), key=lambda kv: (kv[1], kv[0]))
        lat = rec.get("latency_s", 0.0)
        pct = 100.0 * dt / lat if lat > 0 else 0.0
        label = f"shard{rec.get('shard', '?')}/{rec.get('op', '?')}"
        blame = _blame(share, rec.get("chain", []))
        rows.append(f"    p99 {label:<14} {_fmt_us(lat):>9}  "
                    f"{pct:3.0f}% {share}"
                    + (f"  {blame}" if blame else "") + "\n")
    if rows:
        w("  p99 attribution (sampled causal exemplars):\n")
        for row in rows:
            w(row)


def render(snap: Dict, out=sys.stdout) -> None:
    w = out.write
    amp = snap.get("amp") or {}
    if amp:
        w(f"  user writes: {_fmt_bytes(amp.get('user_bytes', 0))} "
          f"({amp.get('user_ops', 0)} ops)\n")
        w(f"  write-amp by source (total {amp.get('wa_total', 0.0):.2f}x):\n")
        wb = amp.get("write_bytes", {})
        for src, ratio in sorted(amp.get("wa_by_source", {}).items()):
            w(f"    {src:<11} {_fmt_bytes(wb.get(src, 0)):>10}  "
              f"{ratio:6.2f}x\n")
        w(f"  space by component (amp {amp.get('sa_total', 0.0):.2f}x):\n")
        comps = amp.get("space", {})
        for k in ("index_bytes", "value_live_bytes", "value_garbage_bytes",
                  "filter_bytes", "other_bytes", "device_total_bytes"):
            if k in comps:
                w(f"    {k:<21} {_fmt_bytes(comps[k]):>10}\n")
        series = amp.get("series") or []
        if series:
            w(f"  ledger windows: {len(series)} "
              f"(last at t={series[-1]['t']:.3f}s)\n")
    reg = snap.get("registry") or {}
    hists = reg.get("histograms", {})
    live = {n: h for n, h in hists.items() if h.get("count")}
    if live:
        w("  latency histograms (p50 / p95 / p99, n):\n")
        for name in sorted(live):
            h = live[name]
            w(f"    {name:<28} {_fmt_us(h['p50']):>9} {_fmt_us(h['p95']):>9}"
              f" {_fmt_us(h['p99']):>9}  n={h['count']}\n")
    render_attribution(reg, w)
    groups = reg.get("counters", {})
    if groups:
        w("  counters:\n")
        for gname in sorted(groups):
            nonzero = {k: v for k, v in groups[gname].items() if v}
            if not nonzero:
                continue
            body = ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in sorted(nonzero.items()))
            w(f"    {gname}: {body}\n")


def main(argv) -> int:
    if not argv:
        print("usage: python -m repro.obs.report METRICS.json",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    # A single snapshot has "registry"/"amp" at top level; a bench dump
    # maps labels to snapshots.
    if "registry" in doc or "amp" in doc:
        doc = {"snapshot": doc}
    for label, snap in doc.items():
        print(f"== {label} (sim t={snap.get('sim_time_s', 0.0):.3f}s) ==")
        render(snap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
