"""Ambient logical-sharding context for activation constraints.

Model code calls ``constrain(x, ("act_batch", None, None))``.  In the JAX
package, inside a ``with activation_rules(mesh, rules):`` scope, that
lowers to ``with_sharding_constraint``, which pins activations
batch-sharded so that the SPMD partitioner all-gathers FSDP weights per
layer instead of all-reducing activation-sized partial sums.

The port has no SPMD partitioner: it runs on one card, on the CPU, or on
meta tensors (the dry-run), and a tensor is never split.  So ``constrain``
returns its tensor unchanged.  Inside a scope it still computes the spec
the JAX package would pin (``spec_for``), so a constraint whose axes do
not fit the tensor fails here as it fails there; the dry-run reads the
same placements to count collective bytes.  Outside a scope it does
nothing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from .sharding import Mesh, Rules, spec_for

_state = threading.local()


@contextlib.contextmanager
def activation_rules(mesh: Mesh, rules: Rules):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules)
    try:
        yield
    finally:
        _state.ctx = prev


def constrain(x, axes: Tuple[Optional[str], ...]):
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    spec_for(tuple(x.shape), axes, rules, mesh)
    return x
