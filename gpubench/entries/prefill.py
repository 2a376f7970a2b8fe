"""The prefill step of ``build_prefill_step``, as a server whose requests
(``batch`` prompts of ``seq`` tokens, a new set each) arrive at a fixed
rate, ``rate`` a second, evenly spaced.  A request is served when the last
position's argmax (its first token) is on the host; its time to first
token runs from when it was due, so time spent queued behind an earlier
request counts.  A traced run serves the requests due in its first
``trace_seconds`` under the profiler instead.

``correct`` compares the tokens of ``checked_requests`` of the served
requests, drawn from the seed, with the reference's logits for their
prompts.
"""

from __future__ import annotations

import math
import random
import statistics
import time

import torch
from torch.profiler import record_function

from .. import cells, checks, port, weights
from ..reference import models as ref_models
from ..reference.models import Precision
from ..trace import STEP


def schedule(traffic: dict, seconds: float):
    """The due times (seconds from the window's start) of the requests due
    within ``seconds``: one every 1 / ``rate``."""
    n = max(1, math.ceil(seconds * traffic["rate"]))
    return [j / traffic["rate"] for j in range(n)]


def _wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


def prompts(ctx, count: int) -> torch.Tensor:
    """(count, batch, seq) token ids of the requests, from the seed."""
    tr = ctx.traffic
    return weights.token_batches(ctx.seed, 1, count, tr["batch"], tr["seq"],
                                 ctx.config["vocab"], ctx.device)


def run(ctx: cells.Context) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    dev = ctx.device
    pcfg = port.model_config(cfg, tr)
    step, abstract = port.prefill_step(pcfg, tr, dev)
    b, s = tr["batch"], tr["seq"]
    params = weights.make_params(cfg, ctx.seed, dev)
    port.check_tree(params, abstract)
    due = schedule(tr, tr["trace_seconds"] if ctx.trace else ctx.seconds)
    requests = prompts(ctx, len(due))
    positions = torch.arange(s, device=dev, dtype=torch.int32).expand(
        b, s).contiguous()
    warm = weights.token_batches(ctx.seed, 2, 1, b, s, cfg["vocab"], dev)[0]
    for _ in range(tr["warmup_calls"]):
        step(params, {"tokens": warm, "positions": positions}).argmax(
            -1).tolist()
    cells.sync(dev)
    result = {"setup_s": time.time() - ctx.t_start}

    served, ttft = [], []

    def serve():
        t0 = time.perf_counter()
        for i, d in enumerate(due):
            _wait_until(t0 + d)
            with record_function(STEP):
                logits = step(params, {"tokens": requests[i],
                                       "positions": positions})
                served.append(logits.argmax(-1).cpu())
            ttft.append(time.perf_counter() - (t0 + d))

    if ctx.trace:
        result["run"] = cells.trace(ctx, serve, lambda: len(served))
    else:
        serve()
        result["ttft_p95_ms"] = 1e3 * statistics.quantiles(
            ttft, n=100, method="inclusive")[94]
        result["window"] = (f"{len(served)} requests, time to first token "
                            f"median {1e3 * statistics.median(ttft):.3f} ms")
    result["attempted"] = len(due)
    result["failed"] = len(due) - len(served)
    cells.record_peak(ctx, result)
    sample = sorted(random.Random(ctx.seed).sample(
        range(len(served)), min(tr["checked_requests"], len(served))))
    checked = [(requests[i], served[i]) for i in sample]
    del params, step
    cells.free(dev)

    gaps = reference(ctx, checked)
    numbers = {"token_gap": {"value": max(gaps),
                             "where": f"{len(gaps)} tokens"}}
    result["correct"], result["checks"] = checks.verdict(numbers,
                                                         ctx.limits)
    result["numbers"] = numbers
    return result


def reference(ctx: cells.Context, checked, prec=None):
    """For each checked request's rows, the reference's best logit less its
    logit for the served token; with ``prec`` (the control), for the token
    that the control puts first."""
    ref_models.f32_mode()
    w = {name: weights.leaf(ctx.config, ctx.seed, i, ctx.device).float()
         for i, (name, *_) in enumerate(weights.leaf_specs(ctx.config))}
    gaps = []
    for prompt, served in checked:
        ref = ref_models.last_logits(w, prompt, ctx.config)
        if prec is not None:
            served = ref_models.last_logits(w, prompt, ctx.config,
                                            prec).argmax(-1)
        gaps += checks.served_gaps(ref, served.to(ref.device))
    return gaps


def controls(ctx: cells.Context) -> dict:
    """{kind: numbers} of the control (the reference with its products one
    precision below the configuration's) against the reference on
    ``ctx.seed``, over ``checked_requests`` requests."""
    gaps = reference(ctx, [(p, None) for p in
                           prompts(ctx, ctx.traffic["checked_requests"])],
                     prec=Precision.control())
    return {"control": {"token_gap": {"value": max(gaps),
                                      "where": f"{len(gaps)} tokens"}}}
