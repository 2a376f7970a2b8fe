"""Device time by the program's parts and passes.

The program names each part of a step by a profiler range, and the pass
by a suffix: ``<part>`` in the forward pass, ``<part>.remat`` where the
remat recompute runs it again inside the backward pass, ``<part>.bwd``
around its gradient operations.  A device operation belongs to the
innermost program range open on the thread that launched it, when it was
launched (``Trace.launch``): ranges on a thread nest, so that is the last
of them to open that has not closed.  A recompute runs inside the
backward of the part that first needs its values, so an operation of
``attention.remat`` nested in ``ffn.bwd`` counts to attention's
recompute.  A program range is named by dotted words (``moe.route.bwd``):
the benchmark's own ranges (``gpubench.*``) and those the profiler or the
collectives open themselves (``nccl:_all_gather_base``) are no part, and an
operation inside one of those belongs to the program range around it.

A program that does not name its passes (no ``.bwd`` range in the trace)
cannot be split by pass: the readers then find nothing.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from .trace import STEP

PASSES = {".remat": "remat", ".bwd": "bwd"}
BENCH = "gpubench."
NAME = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)*")


def is_program_range(name: str) -> bool:
    return NAME.fullmatch(name) is not None and not name.startswith(BENCH)


def split(name: str) -> Tuple[str, str]:
    """(part, pass) of a program range's name; the pass is "forward",
    "remat" or "bwd"."""
    for suffix, kind in PASSES.items():
        if name.endswith(suffix):
            return name[:-len(suffix)], kind
    return name, "forward"


def _innermost(ranges, launches) -> Dict[int, str]:
    """{index: range name} of the launches [(ts, index)] of one thread
    inside any of its ranges [(start, end, name)]."""
    out = {}
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack: List[tuple] = []
    i = 0
    for ts, k in sorted(launches):
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


def owners(trace) -> List[Optional[str]]:
    """For each of ``trace.device``, the program range it belongs to, or
    None."""
    ranges = defaultdict(list)
    for name, tid, a, b in trace.ranges:
        if is_program_range(name):
            ranges[tid].append((a, b, name))
    launches = defaultdict(list)
    for k, (*_, corr) in enumerate(trace.device):
        where = trace.launch.get(corr)
        if where is not None:
            launches[where[0]].append((where[1], k))
    out: List[Optional[str]] = [None] * len(trace.device)
    for tid, ls in launches.items():
        for k, name in _innermost(ranges.get(tid, []), ls).items():
            out[k] = name
    return out


def tags_passes(trace) -> bool:
    return any(is_program_range(name) and split(name)[1] == "bwd"
               for name, *_ in trace.ranges)


def seconds(trace) -> Dict[Tuple[str, str], float]:
    """{(part, pass): device seconds} over the whole trace."""
    out: Dict[Tuple[str, str], float] = defaultdict(float)
    for (a, b, *_), name in zip(trace.device, owners(trace)):
        if name is not None:
            out[split(name)] += (b - a) * 1e-6
    return dict(out)


def ms_per_step(run, parts: Optional[Iterable[str]] = None,
                passes: Optional[Iterable[str]] = None,
                without: Iterable[str] = ()) -> Optional[float]:
    """Device ms per step of the operations in ``parts`` (every part where
    None, less ``without``) and ``passes`` (every pass where None); None
    where the program does not name its passes or no operation counts."""
    if not run.steps or not tags_passes(run.trace):
        return None
    t = sum(s for (part, kind), s in seconds(run.trace).items()
            if (parts is None or part in parts) and part not in without
            and (passes is None or kind in passes))
    return 1e3 * t / run.steps if t > 0 else None


def step_coverage(trace) -> Optional[float]:
    """Of the device time of the operations launched, on any thread, while
    a benchmark step range was open, the share that falls in a program
    range."""
    steps = [(a, b) for name, _, a, b in trace.ranges if name == STEP]
    total = covered = 0.0
    for (a, b, _, corr), owner in zip(trace.device, owners(trace)):
        where = trace.launch.get(corr)
        if where is not None and any(x <= where[1] <= y for x, y in steps):
            total += b - a
            covered += (b - a) if owner is not None else 0.0
    return covered / total if total > 0 else None
