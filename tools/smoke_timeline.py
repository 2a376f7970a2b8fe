#!/usr/bin/env python3
"""Where the wall time of ``chip_smoke.py`` goes, in one or more checkouts.

  python3 tools/smoke_timeline.py DIR [DIR ...] [--out build/timeline]

Runs ``python3 -u chip_smoke.py`` from each DIR in turn (a checkout, e.g.
one unpacked with ``git archive``), stamps each line of its output with the
time it arrived, keeps the stamped output in ``OUT/timeline_<i>_<dir>.log``
and prints one line a run: its exit code, its wall time, the time before
its first line (Python's start, CUDA's and the kernels' build), the build
as ``[build]`` reports it, the ``[checkpoint]`` phase and the repeat checks
where the run has them, and the rest.  Give each checkout twice,
alternating (parent, change, change, parent), to see the spread between
runs.  Exits with the first run's non-zero exit code, if any.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

BUILD = re.compile(r"\[build\] \d+ libraries built in ([\d.]+)s")
CHECKPOINT = re.compile(r"\[checkpoint\] phase wall ([\d.]+) s")
CHECK = re.compile(r"check wall ([\d.]+) s")


def summarize(stamped, start, end):
    """The parts of one run's wall time, from its (time, line) pairs."""
    text = [line for _, line in stamped]

    def found(pattern):
        return [float(m.group(1)) for m in map(pattern.search, text) if m]
    first = stamped[0][0] if stamped else end
    out = {"wall": end - start, "before_first_line": first - start,
           "build": sum(found(BUILD)), "checkpoint": sum(found(CHECKPOINT)),
           "repeat_checks": sum(found(CHECK))}
    out["rest"] = (out["wall"] - out["before_first_line"]
                   - out["checkpoint"] - out["repeat_checks"])
    return out


def run(directory, log):
    start = time.perf_counter()
    stamped = []
    with subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                          cwd=directory, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc, \
            open(log, "w") as f:
        for line in proc.stdout:
            t = time.perf_counter()
            stamped.append((t, line.rstrip("\n")))
            f.write(f"{t - start:10.3f} {line}")
    return proc.returncode, summarize(stamped, start, time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--out", default=os.path.join("build", "timeline"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rcs = []
    for i, d in enumerate(args.dirs):
        name = os.path.basename(os.path.normpath(d))
        rc, parts = run(d, os.path.join(args.out, f"timeline_{i}_{name}.log"))
        rcs.append(rc)
        print(f"[timeline] run {i} {d}: rc {rc}, " + ", ".join(
            f"{k} {v:.3f} s" for k, v in parts.items()), flush=True)
    return next((rc for rc in rcs if rc), 0)


if __name__ == "__main__":
    sys.exit(main())
