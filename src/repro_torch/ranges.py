"""The program's profiler ranges: each part of a step, named with its pass.

A part runs inside ``with part(name) as p:``.  Under a running profiler
(``torch.autograd._profiler_enabled()``) it opens a ``record_function``
range, and the device operations its ops launch fall in that range:

* the forward pass: ``<name>``;
* a recompute, the body run again inside the backward pass (remat's
  non-reentrant ``torch.utils.checkpoint``): ``<name>.remat``;
* the backward pass: ``<name>.bwd``, around the part's gradient ops, on the
  thread where autograd runs them.  ``p.input(x)`` and ``p.output(y)`` mark
  the part's input and output with identity autograd nodes: the output's
  backward opens the range, the input's backward closes it.  Autograd runs
  ready nodes highest sequence number first, so every node made inside
  the part runs between the two.

A device operation belongs to the innermost range open on the thread that
launched it.  A recompute runs inside the backward of the part that first
needs its values, so ``attention.remat`` nests inside ``ffn.bwd``, and
each operation falls in exactly one (part, pass).

With no profiler running, ``part`` opens no range and marks nothing, and
with grad disabled (prefill, decode) or in a recompute it adds no autograd
node: the step's graph and values are those of the program without it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

# Every part of a step, from the input to the update.  ``layer`` is what a
# layer runs around its mixer and FFN: the FSDP gathers of its weights
# (and their reduce-scatters) and the residual adds.
PARTS = ("embed", "layer", "attention", "mamba", "ffn", "moe.route",
         "moe.dispatch", "moe.experts", "moe.combine", "unembed", "loss",
         "grad_norm", "adamw")
PASSES = ("", ".remat", ".bwd")
NAMES = tuple(p + s for p in PARTS for s in PASSES)


def split(name: str) -> Tuple[str, str]:
    """(part, pass) of a range name: pass "forward", "remat" or "bwd"."""
    for suffix in PASSES[1:]:
        if name.endswith(suffix):
            return name[:-len(suffix)], suffix[1:]
    return name, "forward"


class _Backward:
    """A part's ``.bwd`` range, opened and closed from autograd nodes."""

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def open(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        # should the input's backward not run in this pass, close the
        # range when the pass ends
        torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def close(self):
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None


class _Open(torch.autograd.Function):
    """Identity on a part's output; its backward opens the ``.bwd``
    range."""

    @staticmethod
    def forward(ctx, y, marks):
        ctx.marks = marks
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        ctx.marks.open()
        return dy, None


class _Close(torch.autograd.Function):
    """Identity on a part's input; its backward closes the ``.bwd``
    range."""

    @staticmethod
    def forward(ctx, x, marks):
        ctx.marks = marks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        ctx.marks.close()
        return dx, None


class part:
    """``with part(name) as p``: the range of part ``name`` around the
    body; ``p.input(x)`` and ``p.output(y)`` give the tensors the body
    takes and returns, marked for the ``.bwd`` range where a profiler runs
    and the original forward records a graph (else ``x`` and ``y``)."""

    def __init__(self, name: str):
        self.name = name
        self.on = torch.autograd._profiler_enabled()
        self.remat = self.on and torch._C._current_graph_task_id() != -1
        self.marks = None
        self.range = None

    def __enter__(self):
        if self.on:
            self.range = record_function(
                self.name + (".remat" if self.remat else ""))
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

    def input(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.on and not self.remat and torch.is_grad_enabled()
                and x.requires_grad):
            return x
        self.marks = _Backward(self.name + ".bwd")
        return _Close.apply(x, self.marks)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if self.marks is None or not y.requires_grad:
            return y
        return _Open.apply(y, self.marks)
