"""Metrics registry: counter groups and log-bucketed histograms.

Design constraints (from the engines' hot paths):

* Counter increments must stay as cheap as a plain dict ``+=`` — the
  foreground write path does several per op.  ``CounterGroup`` is a
  ``dict`` subclass with *no* method overrides, so ``g["puts"] += 1``
  runs entirely in C.  The registry only adds naming and snapshots.
* Groups are **create-or-reuse**: re-attaching after a crash/recovery
  cycle (same device, hence same registry) returns the existing group
  with only *missing* keys filled from the defaults, so monotonic
  counters are never reset by recovery.
* Histogram recording is gated on ``registry.sampling`` (off by
  default) so the per-op overhead with observability disabled is a
  single attribute test.
* Names are hierarchical (``"shard0/counters"``, ``"wall/commit"``).
  The ``wall/`` prefix marks wall-clock-derived series; snapshots can
  exclude them (``sim_only=True``) so two seeded runs produce
  byte-identical output.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Optional

from .causal import CausalTracer
from .ledger import AmplificationLedger

WALL_PREFIX = "wall/"


class CounterGroup(dict):
    """A named bag of numeric counters.  Plain ``dict`` at runtime."""

    __slots__ = ()


# Histogram bucket scheme: 4 sub-buckets per octave (base 2**0.25, ~19%
# relative resolution).  bucket(x) = OFFSET + floor(log2(x) * 4); the
# offset keeps indices positive for values down to ~1e-45.
_SUBS = 4
_OFFSET = 600
_BASE = 2.0 ** (1.0 / _SUBS)
_NBUCKETS = 1400


class Histogram:
    """Log-bucketed histogram with upper-edge percentile estimates.

    ``percentile(p)`` returns the *upper edge* of the smallest bucket
    whose cumulative count reaches rank ``ceil(p/100 * n)``; the true
    quantile is guaranteed to lie within that bucket, i.e. in
    ``[value / base, value]`` with ``base = 2**0.25``.
    """

    __slots__ = ("name", "count", "sum", "_counts", "_min", "_max")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.count = 0
        self.sum = 0.0
        self._counts: Dict[int, int] = {}
        self._min = math.inf
        self._max = 0.0

    @staticmethod
    def bucket_index(x: float) -> int:
        if x <= 0.0:
            return 0
        i = _OFFSET + math.floor(math.log2(x) * _SUBS)
        return min(max(i, 0), _NBUCKETS - 1)

    @staticmethod
    def bucket_hi(i: int) -> float:
        return 2.0 ** ((i + 1 - _OFFSET) / _SUBS)

    @staticmethod
    def bucket_lo(i: int) -> float:
        return 2.0 ** ((i - _OFFSET) / _SUBS)

    def record(self, x: float) -> None:
        i = self.bucket_index(x)
        self._counts[i] = self._counts.get(i, 0) + 1
        self.count += 1
        self.sum += x
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x

    def record_n(self, x: float, n: int) -> None:
        """Record ``n`` observations of the same value (batch latency
        attributed evenly across the batch's ops)."""
        if n <= 0:
            return
        i = self.bucket_index(x)
        self._counts[i] = self._counts.get(i, 0) + n
        self.count += n
        self.sum += x * n
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x

    def merge(self, other: "Histogram") -> None:
        for i, n in other._counts.items():
            self._counts[i] = self._counts.get(i, 0) + n
        self.count += other.count
        self.sum += other.sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(self.count * p / 100.0))
        cum = 0
        for i in sorted(self._counts):
            cum += self._counts[i]
            if cum >= rank:
                if i == 0:
                    return 0.0
                return self.bucket_hi(i)
        return self.bucket_hi(max(self._counts))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": 0.0 if self.count == 0 else self._min,
            "max": self._max,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": {str(i): self._counts[i] for i in sorted(self._counts)},
        }


class MetricsRegistry:
    """Hierarchical namespace of counter groups and histograms.

    One registry per :class:`BlockDevice`; every store attached to the
    device (solo or sharded, before or after recovery) shares it.
    """

    def __init__(self) -> None:
        self.sampling = False
        self._groups: Dict[str, CounterGroup] = {}
        self._hists: Dict[str, Histogram] = {}
        self.ledger = AmplificationLedger()
        self.causal = CausalTracer()
        # Exemplar buckets must align with Histogram buckets; injected
        # here so causal.py stays free of intra-package imports.
        self.causal.bucket_fn = Histogram.bucket_index

    # -- counters -----------------------------------------------------
    def counters(self, name: str,
                 defaults: Optional[Mapping[str, float]] = None,
                 ) -> CounterGroup:
        g = self._groups.get(name)
        if g is None:
            g = CounterGroup()
            self._groups[name] = g
        if defaults:
            for k, v in defaults.items():
                g.setdefault(k, v)
        return g

    # -- histograms ---------------------------------------------------
    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = Histogram(name)
            self._hists[name] = h
        return h

    def histograms(self, prefix: str = "") -> List[Histogram]:
        return [h for n, h in sorted(self._hists.items())
                if n.startswith(prefix)]

    # -- snapshots ----------------------------------------------------
    def _names(self, names: Iterable[str], sim_only: bool) -> List[str]:
        return sorted(n for n in names
                      if not (sim_only and n.startswith(WALL_PREFIX)))

    def snapshot(self, *, sim_only: bool = False) -> Dict[str, object]:
        hist_names = self._names(self._hists, sim_only)
        return {
            "counters": {n: dict(self._groups[n])
                         for n in self._names(self._groups, sim_only)},
            "histograms": {n: self._hists[n].snapshot()
                           for n in hist_names},
            # Causal exemplars hang off histogram names, so the same
            # wall/ filter applies (sim-only snapshots stay free of
            # wall-clock-derived series).
            "exemplars": self.causal.snapshot(
                self._names(self.causal.exemplars, sim_only)),
        }
