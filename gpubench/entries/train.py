"""The training step of ``build_train_step``, on one card or, with the
mix's ``mesh``, one process a card.

Set-up makes the weights and a pool of ``pool`` batches of token ids on the
card from the seed, and drives the step through its first
``checked_steps`` steps, which the reference follows; the window then runs
whole steps on the next batches of the pool, round and round, until
``--seconds`` have passed, and ends with a synchronise.  A traced run
runs ``trace_steps`` steps under the profiler instead.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import cells, checks, port, weights
from ..reference import models as ref_models
from ..reference import train as ref_train
from ..reference.models import Precision
from ..trace import STEP


def _unit_norms_of(cfg, tree, specs, mesh, scale=1.0, minus=None):
    """{unit: norm} of every leaf of a program tree (this process's blocks
    on a mesh, gathered whole one leaf at a time), times ``scale``, less
    ``minus(i)`` (leaf i of the benchmark's initial weights) where
    given."""
    flat = weights.flatten(tree)
    out = {}
    for i, (name, *_) in enumerate(weights.leaf_specs(cfg)):
        x = flat[name]
        if mesh is not None:
            x = port.runtime.gather_whole_tree(x, specs[name], mesh)
        x = x.float()
        if minus is not None:
            x = x - minus(i)
        out.update(weights.unit_norms(name, x * scale))
        del x
    return out


def checked_batches(ctx) -> tuple:
    """(the pool of batches, (B, S + 1) token ids each, and the first
    ``checked_steps`` of them, which the reference follows)."""
    tr = ctx.traffic
    data = weights.token_batches(ctx.seed, 0, tr["pool"], tr["batch"],
                                 tr["seq"] + 1, ctx.config["vocab"],
                                 ctx.device)
    return data, [data[k] for k in range(tr["checked_steps"])]


def run(ctx: cells.Context) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    dev = ctx.device
    pcfg = port.model_config(cfg, tr)
    mesh = port.make_host_mesh(**tr["mesh"], device=dev) \
        if ctx.world > 1 else None
    step, abstract = port.train_step(pcfg, tr, dev, mesh)
    b, s, pool = tr["batch"], tr["seq"], tr["pool"]
    params = weights.make_params(cfg, ctx.seed, dev)
    port.check_tree(params, abstract)
    specs = None
    if mesh is not None:
        (p_spec, _, _), _ = port.step_specs(pcfg, "train", mesh, b, s,
                                            port.train_config(tr))
        params = port.runtime.shard_tree(params, p_spec, mesh)
        specs = weights.flatten(p_spec)
        cells.free(dev)
    opt = port.init_state(params, port.train_config(tr).adamw)
    data, checked = checked_batches(ctx)
    tokens = data[:, :, :-1].contiguous()
    targets = data[:, :, 1:].contiguous()
    positions = torch.arange(s, device=dev, dtype=torch.int32).expand(
        b, s).contiguous()

    def batch(i):
        return {"tokens": tokens[i % pool], "targets": targets[i % pool],
                "positions": positions}

    # Set-up: the first steps, through the window's own call and feed;
    # the reference follows them.
    b1 = tr["adamw"]["b1"]
    prog = {"loss": [], "grad": {}, "change": {}}
    for k in range(len(checked)):
        params, opt, m = step(params, opt, batch(k))
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad"] = _unit_norms_of(cfg, opt["mu"], specs, mesh,
                                          1.0 / (1.0 - b1))
    prog["change"] = _unit_norms_of(
        cfg, params, specs, mesh,
        minus=lambda i: weights.leaf(cfg, ctx.seed, i, dev).float())
    cells.sync(dev)
    cells.barrier(ctx)
    result = {"setup_s": time.time() - ctx.t_start}

    losses = []
    i = len(checked)

    def one_step():
        nonlocal params, opt, i
        params, opt, m = step(params, opt, batch(i))
        losses.append(m["loss"])
        i += 1

    if not ctx.trace:
        t0 = time.perf_counter()
        while cells.go_on(ctx, time.perf_counter() - t0 < ctx.seconds):
            one_step()
        cells.sync(dev)
        elapsed = time.perf_counter() - t0
        result["train_tokens_per_s"] = len(losses) * b * s / elapsed
        result["window"] = f"{len(losses)} steps in {elapsed:.3f} s"
    else:
        def body():
            for _ in range(tr["trace_steps"]):
                with record_function(STEP):
                    one_step()
        result["run"] = cells.trace(ctx, body, lambda: len(losses))
    result["attempted"] = len(losses)
    result["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    cells.record_peak(ctx, result)
    del params, opt, step, tokens, targets, losses, data
    cells.free(dev)

    numbers = checks.train_numbers(prog, reference(ctx, checked))
    result["correct"], result["checks"] = checks.verdict(numbers,
                                                         ctx.limits)
    result["numbers"] = numbers
    return result


def reference(ctx: cells.Context, checked, prec=None) -> dict:
    """The reference's steps on the checked batches, its rows split over
    the cell's processes."""
    ref_models.f32_mode()
    b = ctx.traffic["batch"]
    rows = range(ctx.rank * b // ctx.world, (ctx.rank + 1) * b // ctx.world)
    reduce = None
    if ctx.world > 1:
        def reduce(x):
            dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return ref_train.train_steps(ctx.config, ctx.traffic["adamw"], ctx.seed,
                                 checked, prec=prec, rows=rows,
                                 reduce=reduce, device=ctx.device)


def controls(ctx: cells.Context) -> dict:
    """{kind: numbers} against the reference on ``ctx.seed``: the control
    (the reference one precision below the configuration's) and a planted
    fault (half of each batch left out, the mean over the rest)."""
    _, checked = checked_batches(ctx)
    ref = reference(ctx, checked)
    ctrl = reference(ctx, checked, prec=Precision.control())
    half = reference(ctx, [x[:x.shape[0] // 2] for x in checked])
    return {"control": checks.train_numbers(ctrl, ref),
            "half_batch": checks.train_numbers(half, ref)}
