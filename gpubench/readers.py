"""What the per-layer metrics' readers share: reductions of a traced run
(``cells.Run``) to one number.  A reader that finds nothing to read
returns None, and the run leaves its metric out.
"""

from __future__ import annotations

import statistics
from typing import Optional

from .kernels import kernel
from .reference import cost
from .trace import STEP


def roofline(run, name: str) -> Optional[float]:
    """The share of its roofline that kernel ``name``
    (``gpubench/kernels/<name>.py``) reaches, in %: the least time of its
    calls over the device time of all its launches."""
    k = kernel(name)
    seconds, launches = run.trace.device_time(k.matches)
    calls = run.calls.get(k.COUNTER, 0)
    if not launches or not calls or seconds <= 0:
        return None
    flops, nbytes, dtype = k.work(run)
    return 100.0 * calls * cost.bound_s(flops, nbytes, dtype) / seconds


def median_step_ms(run) -> Optional[float]:
    spans = run.trace.span_s(STEP)
    return 1e3 * statistics.median(spans) if spans else None


def range_ms(run, name: str) -> Optional[float]:
    """Device time of the operations launched inside the program's range
    ``name``, per step."""
    t = run.trace.range_device_s(name)
    return 1e3 * t / run.steps if t > 0 and run.steps else None


def idle_share_window(run) -> Optional[float]:
    """% of the traced window with no device operation running."""
    t = run.trace
    if not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def idle_share_calls(run) -> Optional[float]:
    """% of the calls' own spans (each call's first device operation to its
    last) with no device operation running: the idle time of serving a
    request, without the wait for the next one to arrive."""
    t = run.trace
    spans = [(min(a for a, _, _ in ops), max(b for _, b, _ in ops))
             for ops in t.ops_in(STEP) if ops]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    intervals = t.busy_intervals()
    busy = sum(max(0.0, min(b, y) - max(a, x))
               for x, y in spans for a, b in intervals if b > x and a < y)
    return 100.0 * (1.0 - busy / total)


def mfu_train(run) -> Optional[float]:
    """% of the cards' bf16 peak that the steps' model flops take over the
    traced window."""
    t = run.trace
    if not t.device or not run.steps or t.window_s <= 0:
        return None
    flops = cost.model_flops(run.config, run.traffic["batch"],
                             run.traffic["seq"], train=True) * run.steps
    return 100.0 * flops / (t.window_s * run.world * cost.MFU_PEAK_FLOPS)


def mfu_calls(run) -> Optional[float]:
    """% of the card's bf16 peak that a call's model flops take over its
    median span."""
    ms = median_step_ms(run)
    if not ms:
        return None
    flops = cost.model_flops(run.config, run.traffic["batch"],
                             run.traffic["seq"], train=False)
    return 100.0 * flops / (ms * 1e-3 * cost.MFU_PEAK_FLOPS)


def nccl(run):
    """(seconds, launches) of the NCCL kernels."""
    return run.trace.device_time(lambda n: "nccl" in n.lower())
