#!/usr/bin/env python3
"""Readings for the limits of ``correct``, at a cell's own sizes, in one
process on one card: the program's numbers on ``--seeds`` (each a run of
the cell with a short window), and on ``--control-seeds`` the control's
(the reference with its products one precision below the configuration's:
``reference.models.Precision.control``) and, for a training cell, a
planted fault's (the reference with half of each batch left out, the mean
over the rest).  The control and the fault need no program, so a cell on
several cards has them read here on one.

  python3 gpubench/calibrate.py --workload <cell> [--seeds 1,2] \\
      [--control-seeds 3,4,5] [--seconds 3] [--out FILE]

Prints one JSON line a reading and, with ``--out``, writes them all.
Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from gpubench import cells  # noqa: E402
from gpubench.manifest import Manifest  # noqa: E402


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    man = Manifest()
    cell = man.cell(args.workload)
    device = torch.device("cuda", 0)
    out = []

    def context(seed):
        return cells.Context(seed, args.seconds, False,
                             man.config(cell["config"]),
                             man.traffic(cell["traffic"]),
                             man.limits(cell["name"]), time.time(), device)

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in _seeds(args.seeds):
        t = time.time()
        r = cells.run(context(seed))
        emit({"cell": cell["name"], "seed": seed, "kind": "program",
              "numbers": r["numbers"], "setup_s": r["setup_s"],
              "wall_s": time.time() - t})
    for seed in _seeds(args.control_seeds):
        t = time.time()
        ctx = context(seed)
        for kind, numbers in cells.entry(ctx.traffic["entry"]).controls(
                ctx).items():
            emit({"cell": cell["name"], "seed": seed, "kind": kind,
                  "numbers": numbers, "wall_s": time.time() - t})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
