#!/usr/bin/env python3
"""One traced run of a training cell of the benchmark, and where its steps'
device time goes by the program's parts and passes.

  python3 tools/step_parts.py --workload olmo-1b.train --seed 7 --seconds 30

runs ``gpubench/run.py --trace 1`` with the same arguments (on as many
cards as the cell asks for) and prints its result line; rank 0 also
prints, to standard error, each (part, pass) of the program's ranges
(``repro_torch.ranges``, read by ``gpubench/parts.py``) in device ms a
step, each pass's and each part's total, the device time in no program
range, the share of the steps' device time that falls in a range
(``parts.step_coverage``), the operations that take the most time in
none, the launches of the program's kernels (K3, K3-bwd, K4, K4-bwd)
by the range they fall in, and every kernel counter of the program
(``gpubench/port.kernel_calls``) a step.  Lines start with ``[parts]``.
"""

from __future__ import annotations

import sys
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gpubench import run as bench_run  # noqa: E402

KERNELS = ("k3", "k3_bwd", "k4", "k4_bwd")


def say(*a):
    print("[parts]", *a, file=sys.stderr, flush=True)


def report(run) -> None:
    from gpubench import parts
    from gpubench.kernels import kernel
    trace, steps = run.trace, run.steps
    table = parts.seconds(trace)
    owners = parts.owners(trace)
    busy = sum(b - a for a, b, *_ in trace.device) * 1e-6
    ranged = sum(table.values())
    say(f"{steps} steps; device time {1e3 * busy / steps:.3f} ms a step, "
        f"{1e3 * ranged / steps:.3f} in program ranges, "
        f"{1e3 * (busy - ranged) / steps:.3f} in none; step coverage "
        f"{100 * (parts.step_coverage(trace) or 0):.3f}%")
    for title, key in (("pass", 1), ("part", 0)):
        sums = defaultdict(float)
        for k, s in table.items():
            sums[k[key]] += s
        say(f"by {title}: " + ", ".join(
            f"{k} {1e3 * s / steps:.3f}" for k, s in
            sorted(sums.items(), key=lambda kv: -kv[1])))
    for (part, kind), s in sorted(table.items(), key=lambda kv: -kv[1]):
        say(f"  {1e3 * s / steps:10.3f} ms  {part} {kind}")
    none = Counter()
    for (a, b, op, _), owner in zip(trace.device, owners):
        if owner is None:
            none[op[:80]] += (b - a) * 1e-3
    say("in no range: " + "; ".join(f"{op} {ms / steps:.3f}" for op, ms in
                                    none.most_common(4)))
    for name in KERNELS:
        k = kernel(name)
        where = Counter(owner for (*_, op, _), owner in
                        zip(trace.device, owners) if k.matches(op))
        if where:
            say(f"{name} launches ({run.calls.get(k.COUNTER, 0)} calls by "
                "the counter): " + ", ".join(f"{o} {n}" for o, n in
                                             sorted(where.items(), key=str)))
    say("the program's counters a step: " + ", ".join(
        f"{name} {n / steps:g}" for name, n in sorted(run.calls.items())
        if n))


def _traced(trace):
    def wrapped(ctx, body, steps):
        run = trace(ctx, body, steps)
        if ctx.rank == 0:
            report(run)
        return run
    return wrapped


def _worker_main(rank, world, store_path, argv, t_start, build_s):
    from gpubench import cells
    cells.trace = _traced(cells.trace)
    sys.exit(bench_run.worker(rank, world, store_path, argv, t_start,
                              build_s))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    from gpubench import cells
    cells.trace = _traced(cells.trace)
    bench_run._worker_main = _worker_main
    return bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
