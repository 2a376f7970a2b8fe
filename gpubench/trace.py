"""The traced run: the profiler around a few steps of the window, and the
reduction of its trace to what the per-layer metrics read.

The trace is the profiler's Chrome trace (``export_chrome_trace``), read
back as JSON: device operations (kernels, copies, fills) with their
start, length and correlation id; the host's launch calls, which carry the
same id and the thread that launched; and the ``record_function`` ranges,
the program's (``adamw``, ``attention``, ``ffn``) and the benchmark's
(``gpubench.window`` around the traced steps, ``gpubench.step`` around
each).  A device operation belongs to a range when the host launched it on
the range's thread inside the range, so the recompute and the backward,
which autograd runs on a thread of its own, fall to the ranges open there.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "gpubench.window"
STEP = "gpubench.step"


@contextlib.contextmanager
def traced(out: dict, device):
    """Profile the body, which runs inside the ``gpubench.window`` range
    and ends with a synchronise; on exit, ``out["trace"]`` is its
    ``Trace``.  (On the CPU, where the tests run, the host alone.)"""
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    out["trace"] = Trace(data["traceEvents"] if isinstance(data, dict)
                         else data)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """One process's trace, times in microseconds."""

    def __init__(self, events: List[dict]):
        self.device = []          # (start, end, name, correlation)
        launches = {}             # correlation -> (tid, ts)
        self.ranges = []          # (name, tid, start, end)
        self.host = []            # (start, end, name, tid): ops and ranges
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                self.device.append((e["ts"], e["ts"] + e.get("dur", 0),
                                    e["name"],
                                    e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e["tid"], e["ts"])
            elif cat == "user_annotation":
                self.ranges.append((e["name"], e["tid"], e["ts"],
                                    e["ts"] + e.get("dur", 0)))
            if cat in ("cpu_op", "user_annotation"):
                self.host.append((e["ts"], e["ts"] + e.get("dur", 0),
                                  e["name"], e["tid"]))
        self.launch = {c: launches.get(c) for *_, c in self.device}
        win = [r for r in self.ranges if r[0] == WINDOW]
        if not win:
            raise ValueError("the trace holds no gpubench.window range")
        _, self.main_tid, self.t0, self.t1 = win[0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, cut to the
        window."""
        return _union([(max(a, self.t0), min(b, self.t1))
                       for a, b, *_ in self.device
                       if b > self.t0 and a < self.t1])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_time(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name matches."""
        t, n = 0.0, 0
        for a, b, name, _ in self.device:
            if match(name):
                t += b - a
                n += 1
        return t * 1e-6, n

    def ops_in(self, range_name: str) -> List[list]:
        """For each instance of the range, the device operations launched
        inside it: [(start, end, name), ...] a list an instance."""
        inst = [r for r in self.ranges if r[0] == range_name]
        by_tid = defaultdict(list)
        for i, (_, tid, a, b) in enumerate(inst):
            by_tid[tid].append((a, b, i))
        out: List[list] = [[] for _ in inst]
        for a, b, name, corr in self.device:
            where = self.launch.get(corr)
            if where is None:
                continue
            tid, ts = where
            for ra, rb, i in by_tid.get(tid, ()):
                if ra <= ts <= rb:
                    out[i].append((a, b, name))
                    break
        return out

    def range_device_s(self, range_name: str) -> float:
        """The device time of every operation launched inside any instance
        of the range (an operation counted once where instances nest)."""
        seen = set()
        for ops in self.ops_in(range_name):
            seen.update(ops)
        return sum(b - a for a, b, _ in seen) * 1e-6

    def span_s(self, range_name: str) -> List[float]:
        """For each instance of the range, the time from its first device
        operation's start to its last one's end."""
        return [(max(b for _, b, _ in ops) - min(a for a, _, _ in ops)) * 1e-6
                for ops in self.ops_in(range_name) if ops]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, summed by name,
        and the idle time summed by what the host's main thread was doing
        when each gap began (the innermost op or range open there)."""
        ops: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            if b > self.t0 and a < self.t1:
                ops[_short(name)] += (b - a) * 1e-6
        busy = self.busy_intervals()
        gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
        if busy:
            gaps = [(self.t0, busy[0][0])] + gaps + [(busy[-1][1], self.t1)]
        main = sorted((h for h in self.host if h[3] == self.main_tid),
                      key=lambda h: h[0])
        starts = [h[0] for h in main]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            if b > a:
                idle[_host_at(main, starts, a)] += (b - a) * 1e-6
        return {"device_ops": _top(ops, top), "idle_gaps": _top(idle, top)}


def _host_at(main, starts, t: float, reach: int = 4096) -> str:
    """The innermost host op or range open at ``t``: of those that started
    by ``t`` and had not ended, the last to start (looked for among the
    ``reach`` that started last)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if main[j][1] >= t:
            return "host: " + _short(main[j][2])
    return "host: between ops"


def _short(name: str, limit: int = 120) -> str:
    name = name.replace("void ", "", 1)
    return name if len(name) <= limit else name[:limit]


def _top(d: Dict[str, float], n: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
