"""Ambient logical-sharding context for activation constraints, and the
running step's split of the model.

Model code calls ``constrain(x, ("act_batch", None, None))``.  In the JAX
package, inside a ``with activation_rules(mesh, rules):`` scope, that
lowers to ``with_sharding_constraint``, which pins activations
batch-sharded so that the SPMD partitioner all-gathers FSDP weights per
layer instead of all-reducing activation-sized partial sums.

The port has no SPMD partitioner.  On a mesh that plans only (the
dry-run's, or one process's), a tensor is never split.  On a mesh that
runs (``parallel.runtime``) each process computes on its own rows of the
batch: an activation is already batch-local, which is the placement
``("act_batch", ...)`` asks for.  So ``constrain`` returns its tensor
unchanged.  Inside a scope it still computes the spec the JAX package
would pin (``spec_for``), so a constraint whose axes do not fit the
tensor fails here as it fails there; the dry-run reads the same
placements to count collective bytes.  Outside a scope it does nothing.

The scope of a step that runs across processes also carries:

* the process group over which it has split its batch, or None where
  every process holds the whole batch (``batch_group``): the MoE routes
  over the whole batch, so under a split it gathers the tokens of every
  process first (``models/modules.py``);
* the mesh's ``model`` group: a layer asks ``model_split`` whether the
  step splits one of its leaves over ``model`` (the leaf's spec, from
  ``spec_for`` on its whole shape and logical axes, as ``step_specs``
  lays the step's params out), and where, and then computes on its
  block (tensor and expert parallelism).  Without such a scope every
  leaf is whole;
* in a decode step, how its KV cache splits along the sequence
  (``seq_split``): each process holds a block of the positions, and the
  attention of one token merges the blocks' partial softmaxes over the
  group that splits them.  A dimension split over two axes (``cache_seq``
  over ``data`` and ``model`` under ``long_context_rules``) has a group of
  its own here; a param leaf's stays refused (``model_split``).
"""

from __future__ import annotations

import contextlib
import types
from typing import Any, NamedTuple, Optional, Tuple

from .runtime import coords
from .sharding import Mesh, Rules, spec_axes, spec_for

# One scope for the whole process, not one a thread: under remat the
# backward pass runs the forward again, and on the card autograd runs it
# on its own device thread, which must see the scope the step opened.
_state = types.SimpleNamespace(ctx=None)


class Split(NamedTuple):
    """A leaf split over the ``model`` axis: along dimension ``dim``, this
    process holds block ``rank`` of ``size``; ``group`` is the model
    group."""
    dim: int
    rank: int
    size: int
    group: Any

    def block(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this process's block of a dimension of n."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


class SeqSplit(NamedTuple):
    """A decode step's KV cache along its sequence: this process holds
    block ``index`` of ``size`` (positions [index·S/size, (index+1)·S/size)
    of S), and ``group`` holds the processes of the other blocks, or is
    None where the sequence is whole."""
    group: Any
    index: int
    size: int


@contextlib.contextmanager
def activation_rules(mesh: Mesh, rules: Rules, batch_group=None,
                     model_group=None, seq: Optional[SeqSplit] = None):
    prev = _state.ctx
    _state.ctx = (mesh, rules, batch_group, model_group, seq)
    try:
        yield
    finally:
        _state.ctx = prev


def constrain(x, axes: Tuple[Optional[str], ...]):
    ctx = _state.ctx
    if ctx is None:
        return x
    mesh, rules = ctx[:2]
    spec_for(tuple(x.shape), axes, rules, mesh)
    return x


def batch_group():
    """The group the running step splits its batch over, or None."""
    ctx = _state.ctx
    return None if ctx is None else ctx[2]


def model_split(shape: Tuple[int, ...],
                axes: Tuple[Optional[str], ...]) -> Optional[Split]:
    """Where the running step splits a leaf of whole ``shape`` and logical
    ``axes`` over the mesh's ``model`` axis, or None: no step runs across
    processes, or ``spec_for`` left the leaf whole over ``model`` (a
    dimension that does not divide).  At a model size of 1 a leaf whose
    spec names ``model`` is split, into one block."""
    ctx = _state.ctx
    if ctx is None or ctx[3] is None:
        return None
    mesh, rules, _, group, _ = ctx
    for dim, entry in enumerate(spec_for(tuple(shape), tuple(axes), rules,
                                         mesh)):
        if "model" in spec_axes(entry):
            if entry != "model":
                raise NotImplementedError(
                    f"a leaf {tuple(shape)} split over {entry}: only a "
                    "dimension split over model alone is executed")
            return Split(dim, coords(mesh)["model"], mesh.shape["model"],
                         group)
    return None


def seq_split() -> Optional[SeqSplit]:
    """How the running decode step splits its KV cache's sequence, or
    None: no decode step runs across processes."""
    ctx = _state.ctx
    return None if ctx is None else ctx[4]
