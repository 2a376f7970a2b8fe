"""One run of a cell: its configuration and its traffic mix's parameters,
handed to the entry that the mix names.

A mix's ``entry`` names the program's entry that its window drives, a
module of its own found by name as ``gpubench/entries/<entry>.py`` (so a
later change adds an entry by adding its module, and edits no file that is
there).  An entry gives ``run(ctx)``, which makes the inputs from the seed,
drives the window (or, with ``--trace 1``, a traced stretch of it) and
decides ``correct``, and ``controls(ctx)``, the control's readings
(``gpubench/calibrate.py``).  What entries share is here.
"""

from __future__ import annotations

import gc
import importlib

import torch
import torch.distributed as dist

from . import port
from .trace import traced


class Run:
    """What the per-layer readers of one run read: the configuration, the
    mix, the trace of the traced steps, the number of steps (or requests)
    traced, the program's kernel-call counts over them, and the processes
    the cell ran on."""

    def __init__(self, config, traffic, trace, steps, calls, world=1):
        self.config = config
        self.traffic = traffic
        self.trace = trace
        self.steps = steps
        self.calls = calls
        self.world = world


class Context:
    def __init__(self, seed, seconds, trace, config, traffic, limits,
                 t_start, device, rank=0, world=1):
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.t_start = t_start
        self.device = device
        self.rank = rank
        self.world = world
        self.host_group = None


def entry(name: str):
    """The module of entry ``name``."""
    return importlib.import_module(f"gpubench.entries.{name}")


def run(ctx: Context) -> dict:
    return entry(ctx.traffic["entry"]).run(ctx)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    gc.collect()
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def record_peak(ctx, result: dict) -> None:
    """The most memory allocated on the card so far, on the fullest card
    of the cell (0 on the CPU, where the tests run), into ``result``."""
    here = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    peak = torch.tensor(float(here), device=ctx.device, dtype=torch.float64)
    if ctx.world > 1:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    result["memory_peak_bytes"] = int(peak.item())
    result["peak_mem_gib"] = result["memory_peak_bytes"] / 2 ** 30


def go_on(ctx, mine: bool) -> bool:
    """Whether every process goes on: on a mesh, an all-reduce over the
    host group (gloo), so no process waits for its card."""
    if ctx.world == 1:
        return mine
    flag = torch.tensor([int(mine)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=ctx.host_group)
    return bool(flag.item())


def barrier(ctx):
    if ctx.world > 1:
        dist.barrier()


def trace(ctx, body, steps) -> Run:
    """Run ``body()`` under the profiler; the ``Run`` of its trace, with
    the program's kernel calls inside it and ``steps()`` steps (or
    requests) after it."""
    calls0 = port.kernel_calls()
    out = {}
    with traced(out, ctx.device):
        body()
    calls = {k: v - calls0.get(k, 0) for k, v in port.kernel_calls().items()}
    return Run(ctx.config, ctx.traffic, out["trace"], steps(), calls,
               ctx.world)
