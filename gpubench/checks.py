"""The comparison that decides ``correct``: the numbers read from the
program's timed path against the reference's, each held to the limit the
cell's limits file sets.

Training cells compare three numbers over the steps the reference follows:

* ``loss``: the largest relative gap of a step's loss;
* ``grad``: the first step's gradient as the optimizer took it (its first
  moment after one step, over 1 - b1), by the worst unit: the gap between
  the program's norm and the reference's, over the reference's norm of the
  unit or of the median unit, whichever is larger;
* ``change``: the weights' change over those steps, by the worst unit in
  the same way.

A unit is one layer's slice of a stacked leaf, or a leaf.  Units whose
reference gradient is under a thousandth of the median unit's (the norm
gains that OLMo's non-parametric LayerNorm never reads) move under AdamW by
weight decay alone and are left out of both.

Served cells compare ``token_gap``: over a sample of the requests the window
finished, the widest gap by which a served token's reference logit lies
below the reference's best logit at that position.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

NEGLIGIBLE = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           counted: List[str]) -> Tuple[float, str]:
    median = statistics.median(ref[u] for u in counted)
    worst, where = 0.0, ""
    for u in counted:
        gap = abs(prog[u] - ref[u]) / max(ref[u], median)
        if gap > worst or not where:
            worst, where = gap, u
    return worst, where


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """{number: {"value", "where"}} of a training cell.  ``prog`` and
    ``ref`` hold "loss" (a list), "grad" and "change" ({unit: norm})."""
    steps = len(ref["loss"])
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    loss = [x if x == x else float("inf") for x in loss]
    g_median = statistics.median(ref["grad"].values())
    counted = [u for u, g in ref["grad"].items()
               if g >= NEGLIGIBLE * g_median]
    grad, g_at = _worst(prog["grad"], ref["grad"], counted)
    change, c_at = _worst(prog["change"], ref["change"], counted)
    worst_step = max(range(steps), key=lambda i: loss[i])
    return {"loss": {"value": max(loss), "where": f"step {worst_step + 1}"},
            "grad": {"value": grad, "where": g_at},
            "change": {"value": change, "where": c_at}}


def served_gaps(ref_logits, served) -> List[float]:
    """For each row, the reference's best logit less its logit for the
    served token.  ref_logits (rows, V) f32; served: rows token ids."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[:, None])[:, 0]
    return (best - got).tolist()


def verdict(numbers: Dict[str, dict], limits: dict) -> Tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    that the cell's limits name is at or under its limit.  A number that is
    not finite fails.  A number the limits do not name (one that neither
    the control nor a fault separates from sound runs) is not compared."""
    checks, ok = {}, True
    for name, n in numbers.items():
        if name not in limits:
            continue
        limit = limits[name]["limit"]
        value = n["value"]
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, checks
