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
  over ``data`` and ``model``, or over ``pod``, ``data`` and ``model``,
  under ``long_context_rules``) has a group of its own here; a param
  leaf's stays refused (``model_split``);
* the spec tree of the step's params, as ``step_specs`` lays them out:
  the params arrive as blocks, FSDP-split over ``data``, and a layer
  gathers its own leaves whole over ``data`` when it runs
  (``gather_layer``; the embedding and the unembedding theirs,
  ``gather_params``), as XLA gathers them per layer under the JAX
  package's batch-sharded constraints.  Under remat a layer's recompute
  gathers them again.
"""

from __future__ import annotations

import contextlib
import types
from typing import Any, NamedTuple, Optional, Tuple

from . import runtime
from .runtime import coords
from .sharding import (Mesh, PartitionSpec, Rules, spec_axes, spec_for,
                       tree_map)

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


class _Scope(NamedTuple):
    mesh: Mesh
    rules: Rules
    batch_group: Any
    model_group: Any
    seq: Optional[SeqSplit]
    params: Any


@contextlib.contextmanager
def activation_rules(mesh: Mesh, rules: Rules, batch_group=None,
                     model_group=None, seq: Optional[SeqSplit] = None,
                     params=None):
    """The scope of a step on ``mesh``: ``params``, where given, is the
    spec tree of the blocks the step's params arrive as (the step runs
    across processes and its layers gather them, ``gather_params``)."""
    prev = _state.ctx
    _state.ctx = _Scope(mesh, rules, batch_group, model_group, seq, params)
    try:
        yield
    finally:
        _state.ctx = prev


def constrain(x, axes: Tuple[Optional[str], ...]):
    ctx = _state.ctx
    if ctx is None:
        return x
    spec_for(tuple(x.shape), axes, ctx.rules, ctx.mesh)
    return x


def batch_group():
    """The group the running step splits its batch over, or None."""
    ctx = _state.ctx
    return None if ctx is None else ctx.batch_group


def gathers_params() -> bool:
    """Whether the running step holds its params as blocks that its
    layers gather (``gather_params``)."""
    ctx = _state.ctx
    return ctx is not None and ctx.params is not None


def _gather_tree(tree, spec_tree):
    ctx = _state.ctx
    group = ctx.mesh.axis_group("data")
    summed = ctx.batch_group is not None

    def gather(x, spec):
        dim = runtime.data_dim(spec)
        return x if dim is None else runtime.gather_data(x, dim, group,
                                                         summed)
    return tree_map(gather, tree, spec_tree)


def _specs(path):
    node = _state.ctx.params
    for key in path:
        node = node[key]
    return node


def gather_params(tree, *path: str):
    """``tree``, the sub-tree (or leaf) of the running step's params at
    ``path`` (``"unembed"``, ...), with every leaf that the step splits
    over ``data`` gathered whole over ``data`` for this use
    (``runtime.gather_data``; backward, its gradient goes back to the
    block).  Outside a step that gathers its params, ``tree`` as it is."""
    if not gathers_params():
        return tree
    return _gather_tree(tree, _specs(path))


def gather_layer(lp, *path: str):
    """``gather_params`` for one layer ``lp`` of the stacked sub-tree at
    ``path`` (``"layers"``; ``"blocks", "pos3"``): a layer's spec is its
    stacked leaf's without the leading ``layers`` entry."""
    if not gathers_params():
        return lp
    return _gather_tree(lp, tree_map(lambda spec: PartitionSpec(*spec[1:]),
                                     _specs(path)))


def model_split(shape: Tuple[int, ...],
                axes: Tuple[Optional[str], ...]) -> Optional[Split]:
    """Where the running step splits a leaf of whole ``shape`` and logical
    ``axes`` over the mesh's ``model`` axis, or None: no step runs across
    processes, or ``spec_for`` left the leaf whole over ``model`` (a
    dimension that does not divide).  At a model size of 1 a leaf whose
    spec names ``model`` is split, into one block."""
    ctx = _state.ctx
    if ctx is None or ctx.model_group is None:
        return None
    mesh, rules, group = ctx.mesh, ctx.rules, ctx.model_group
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
    return None if ctx is None else ctx.seq
