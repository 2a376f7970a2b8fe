#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``repro_torch`` on NVIDIA cards.

  python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix,
its limits and its per-layer metrics are found by name from
``BENCHMARK.json`` (``gpubench/manifest.py``).  A cell on more than one card
starts one process a card (NCCL, a FileStore under TMPDIR); rank 0 prints.

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``build_s`` (the seconds of set-up that built the
program's kernels, which ``setup_s`` includes: nought but in a checkout's
first run) and last ``checks``: each number compared for ``correct`` with
its limit, which also end standard error.  Exits non-zero, printing
no result, where the cards are missing or too few, where the program
cannot be loaded, and where a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench.manifest import Manifest  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
RUN_TIMEOUT_S = 330


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def build_kernels() -> float:
    """Build the program's kernel libraries that the checkout lacks (nvcc,
    the first run in a checkout; a later run finds them built) and return
    the seconds it took.  Done before the cards are touched, once for all
    the cell's processes."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build
    t = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t


def worker(rank, world, store_path, argv, t_start, build_s):
    """One process of a run: rank 0 prints the result.  Returns the exit
    code."""
    import torch
    import torch.distributed as dist

    from gpubench import cells

    args = parse(argv)
    man = Manifest()
    cell = man.cell(args.workload)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    ctx = cells.Context(args.seed, args.seconds, bool(args.trace),
                        man.config(cell["config"]),
                        man.traffic(cell["traffic"]), man.limits(cell["name"]),
                        t_start, device, rank, world)
    if world > 1:
        from gpubench import port
        port.runtime.init_group("cuda", dist.FileStore(store_path, world),
                                rank, world, timeout=timedelta(minutes=5))
        ctx.host_group = dist.new_group(backend="gloo")
    try:
        result = cells.run(ctx)
        run = result.get("run")
        busy = [run.trace.busy_s] if run is not None else []
        found = forbidden_modules()
        if world > 1:
            every = [None] * world
            dist.all_gather_object(every, (busy, found))
            busy = [b for bs, _ in every for b in bs]
            found = sorted({f for _, fs in every for f in fs})
    finally:
        if world > 1:
            dist.destroy_process_group()
    if rank != 0:
        return 0
    if found:
        say(f"gpubench: modules of JAX or of the JAX package are loaded: "
            f"{', '.join(found)}")
        return 3
    metrics = {}
    if run is None:
        for m in man.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": result[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in man.per_layer(cell["name"]):
            value = man.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": world, "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if run is not None:
        dev["busy_s"] = statistics.fmean(busy)
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["build_s"] = build_s
    line["checks"] = result["checks"]
    say(f"setup_s {result['setup_s']:.3f}, of it build_s {build_s:.3f}; "
        f"window: {result.get('window', 'traced')}")
    for name, n in result["numbers"].items():
        limit = result["checks"].get(name, {}).get("limit", "none, not "
                                                   "compared")
        say(f"check {name}: {n['value']!r} limit {limit!r} (worst at "
            f"{n['where']})")
    say(f"correct: {result['correct']}")
    print(json.dumps(line), flush=True)
    return 0


def _worker_main(rank, world, store_path, argv, t_start, build_s):
    sys.exit(worker(rank, world, store_path, argv, t_start, build_s))


def launch(world, argv, build_s) -> int:
    """Run the cell in ``world`` processes, one a card; wait for each, and
    end any that outlives the run's time."""
    fd, store = tempfile.mkstemp(prefix="gpubench-store-")
    os.close(fd)
    os.remove(store)
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_worker_main,
                        args=(r, world, store, argv, T_START, build_s))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = T_START + RUN_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if os.path.exists(store):
            os.remove(store)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        say(f"gpubench: the processes exited {codes}")
        return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    cell = Manifest().cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        say(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
            f"card(s); {have} found")
        return 2
    build_s = build_kernels()
    if cell["chips"] == 1:
        return worker(0, 1, None, argv, T_START, build_s)
    return launch(cell["chips"], argv, build_s)


if __name__ == "__main__":
    sys.exit(main())
