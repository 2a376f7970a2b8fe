"""Ambient logical-sharding context for activation constraints.

Model code calls ``constrain(x, ("act_batch", None, None))``.  In the JAX
package, inside a ``with activation_rules(mesh, rules):`` scope, that
lowers to ``with_sharding_constraint``, which pins activations
batch-sharded so that the SPMD partitioner all-gathers FSDP weights per
layer instead of all-reducing activation-sized partial sums.

The port has no SPMD partitioner.  On a mesh that plans only (the
dry-run's, or one process's), a tensor is never split.  On a mesh that
runs (``parallel.runtime``) only the ``data`` axis is executed, and each
process computes on its own rows of the batch: an activation is already
batch-local, which is the placement ``("act_batch", ...)`` asks for.  So
``constrain`` returns its tensor unchanged.  Inside a scope it still
computes the spec the JAX package would pin (``spec_for``), so a
constraint whose axes do not fit the tensor fails here as it fails there;
the dry-run reads the same placements to count collective bytes.  Outside
a scope it does nothing.

The scope also carries the process group over which the running step has
split its batch, or None where every process holds the whole batch
(``batch_group``): the MoE routes over the whole batch, so under a split
it gathers the tokens of every process first (``models/modules.py``).
"""

from __future__ import annotations

import contextlib
import types
from typing import Optional, Tuple

from .sharding import Mesh, Rules, spec_for

# One scope for the whole process, not one a thread: under remat the
# backward pass runs the forward again, and on the card autograd runs it
# on its own device thread, which must see the scope the step opened.
_state = types.SimpleNamespace(ctx=None)


@contextlib.contextmanager
def activation_rules(mesh: Mesh, rules: Rules, batch_group=None):
    prev = _state.ctx
    _state.ctx = (mesh, rules, batch_group)
    try:
        yield
    finally:
        _state.ctx = prev


def constrain(x, axes: Tuple[Optional[str], ...]):
    ctx = _state.ctx
    if ctx is None:
        return x
    mesh, rules, _ = ctx
    spec_for(tuple(x.shape), axes, rules, mesh)
    return x


def batch_group():
    """The group the running step splits its batch over, or None."""
    ctx = _state.ctx
    return None if ctx is None else ctx[2]
