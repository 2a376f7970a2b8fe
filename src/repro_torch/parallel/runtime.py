"""Running a mesh: one process a device, in a ``torch.distributed``
group, and the collectives that move a tree between its whole form and
the blocks its processes hold, and the activations of a split layer
between its processes.

The JAX package has no module like this one: under ``jax.jit`` with
``in_shardings`` XLA's partitioner inserts the all-gathers and
reduce-scatters itself.  Here the train and prefill steps call them
(``train/step.py``), and the layers call the model axis's
(``models/modules.py``):

* ``shard_tree`` keeps this process's block of each tensor of a whole tree;
* ``gather_data`` gathers one param block whole over the ``data`` group
  for one use (a layer's weights in its forward, again in its recompute,
  and in each decode token: ``parallel.ctx.gather_params``, as XLA
  gathers FSDP weights per layer), and backward reduce-scatters its
  gradient into the block (or takes its block where every process
  computed the whole batch); ``gathered`` counts these gathers, their
  bytes, and the gathered bytes alive at once;
* ``gather_whole_tree`` gathers a tree of blocks whole over ``data`` and
  ``model`` (checkpoints);
* ``reduce_tree`` sums the rest of a step's gradients over the batch's
  processes: a leaf not split over ``data`` all-reduced over the batch's
  group, a block (already summed over ``data`` in the backward)
  all-reduced over ``pod``;
* ``global_norm`` is √(Σ g²) over a tree of blocks: a leaf's blocks add up
  over every axis that splits it, and a leaf replicated over an axis
  counts once;
* ``gather_rows`` is a differentiable all-gather of batch rows (the MoE
  routes the whole batch's tokens, as one device does).  It stands where
  ``torch.distributed.nn.functional.all_gather`` would: that one is
  deprecated in torch 2.13, and its backward takes another collective on
  each backend (a reduce-scatter on NCCL, an all-to-all and a stacked sum
  on gloo); this one is the same two collectives on both;
* ``to_model`` and ``from_model``, the two conjugate operators of tensor
  parallelism over the ``model`` group: a replicated activation enters a
  split computation through ``to_model`` (identity forward, all-reduce of
  its gradient backward), and a split computation's partial output leaves
  through ``from_model`` (all-reduce forward, identity backward).  Then
  the gradient of a leaf that every model process holds whole is whole
  and the same on each;
* ``gather_model`` gathers a split leaf whole over ``model`` for a
  computation that needs all of it (the MoE's router), and gives its
  block of the (whole, equal) gradient back;
* ``gather_blocks`` gathers a split leaf whole over a group for a
  computation that each process runs on its own part of it (Mamba-2's
  packed ``w_in``, whose blocks do not fall on its components): the
  gradients differ from process to process, so backward they are summed
  into each process's block (a reduce-scatter);
* ``psum``, a differentiable all-reduce whose result each process uses
  on its own part (the gated norm's sum of squares over a split
  ``d_inner``): forward and backward both sum over the group;
* ``axes_group`` is the group of the processes that split one dimension
  over several axes (the batch over ``pod`` and ``data``, a KV cache's
  sequence over ``data`` and ``model`` or over all three).

A leaf is split over an axis when its spec names the axis (``spec_for``),
whatever the axis's size: at one process each collective is a copy, so a
group of one runs the same code as a group of many.  ``counts`` counts the
calls of ``to_model``, ``from_model``, ``gather_blocks``, ``psum``, the
vocabulary-parallel loss and the decode's log-sum-exp merge over a split
sequence (``models/modules.py``), so a run can show that it took the split
path.
The collectives are ``all_gather_into_tensor``, ``reduce_scatter_tensor``
and ``all_reduce``, which both the gloo and the NCCL backends run; a
dimension other than 0 is moved to the front first (a copy; a block
whose dimension 0 is the split one, as most of a layer's weights are,
goes to the collective as it is).
"""

from __future__ import annotations

import os
import threading
import warnings
import weakref
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharding import (Mesh, PartitionSpec, local_slice, mesh_coords,
                       spec_axes, tree_map)

# torch 2.13 marks the two collectives deprecated in favour of names that
# torch 2.11 does not have; both versions run them.
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched_by_torchrun() -> bool:
    """Whether ``torch.distributed.run`` started this process."""
    return all(k in os.environ for k in TORCHRUN_VARS)


def init_group(device="cuda", store: Optional[dist.Store] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout: timedelta = timedelta(minutes=10)) -> torch.device:
    """Start the default process group, one process a device: ``nccl`` for
    the card, ``gloo`` for the CPU.  Without a ``store`` the group comes
    from the variables torchrun sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); with one (a
    ``FileStore``), from ``rank`` and ``world_size``, all on one host.
    Returns the device this process runs on: on the card, the one its
    local rank names, made the current device.  A group that cannot start
    raises."""
    dev = resolve_device(device)
    if store is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local = int(os.environ["LOCAL_RANK"])
        how = {"init_method": "env://"}
    else:
        local = rank
        how = {"store": store}
    if dev.type == "cuda":
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        how["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=rank, world_size=world_size,
                            timeout=timeout, **how)
    return dev


counts = {"to_model": 0, "from_model": 0, "vocab_loss": 0,
          "gather_blocks": 0, "psum": 0, "seq_merge": 0}


# gather_data's gathers: their number, their bytes, and the bytes of the
# gathered tensors alive now and at most since the last reset
gathered = {"calls": 0, "bytes": 0, "live": 0, "peak": 0}
# a gathered tensor may be freed on autograd's device thread
_gathered_lock = threading.Lock()


def reset_counts() -> None:
    """Zero ``counts`` and ``gathered`` (its ``live`` bytes stay: they
    are tensors that still exist)."""
    with _gathered_lock:
        for k in counts:
            counts[k] = 0
        for k in ("calls", "bytes"):
            gathered[k] = 0
        gathered["peak"] = gathered["live"]


def check_executable(mesh: Mesh) -> None:
    """Raise unless the mesh's processes can run it: one process a device,
    and no axis but ``pod``, ``data`` and ``model`` larger than 1."""
    n = dist.get_world_size(mesh.group)
    if n != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} devices in a group of {n} "
                         "processes")
    wide = {a: s for a, s in mesh.shape.items()
            if a not in ("pod", "data", "model") and s > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: only the pod, data and model axes are "
            "executed")


def rank(mesh: Mesh) -> int:
    """This process's rank in the mesh's group; 0 on a mesh without one."""
    return 0 if mesh.group is None else dist.get_rank(mesh.group)


def barrier(mesh: Mesh) -> None:
    """Wait for every process of the mesh's group; nothing without one."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def coords(mesh: Mesh):
    return mesh_coords(mesh, rank(mesh))


def axes_group(mesh: Mesh, axes: Tuple[str, ...]):
    """The group of the processes that split one dimension over ``axes``
    (this process's, in the order of the blocks: row-major over the axes'
    coordinates): one axis's group, the mesh's group where ``axes`` hold
    every axis larger than 1, or the group ``make_host_mesh`` built for
    them (``("pod", "data")``, the batch's)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.axis_group(axes[0])
    if all(a in axes for a, s in mesh.shape.items() if s > 1):
        return mesh.group
    if axes in mesh.axis_groups:
        return mesh.axis_groups[axes]
    raise NotImplementedError(f"a dimension split over {axes} on a mesh "
                              f"{mesh.shape}")


def axis_dim(spec: PartitionSpec, axis: str) -> Optional[int]:
    """The dimension a spec splits over ``axis``, or None (replicated)."""
    for i, entry in enumerate(spec):
        if axis in spec_axes(entry):
            if entry != axis:
                raise NotImplementedError(
                    f"{spec}: a dimension split over {entry}; only one "
                    "axis a dimension is executed")
            return i
    return None


def data_dim(spec: PartitionSpec) -> Optional[int]:
    """The dimension a spec splits over ``data``, or None (replicated)."""
    return axis_dim(spec, "data")


def full_shape(shape: Tuple[int, ...], spec: PartitionSpec,
               mesh: Mesh) -> Tuple[int, ...]:
    """The whole tensor's shape, from one block's."""
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[i] *= mesh.shape[a]
    return tuple(out)


def local_block(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh):
    """A view of this process's block of the whole tensor ``x``."""
    return x[local_slice(tuple(x.shape), spec, mesh, coords(mesh))]


def shard_tree(full_tree, spec_tree, mesh: Mesh):
    """This process's block of each whole tensor, as a contiguous copy.  A
    mesh without a group holds whole tensors: the tree is returned as it
    is."""
    if mesh.group is None:
        return full_tree
    return tree_map(lambda x, spec: local_block(x, spec, mesh).clone(
        memory_format=torch.contiguous_format), full_tree, spec_tree)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def gather_whole_tree(local_tree, spec_tree, mesh: Mesh):
    """The whole tensors from every process's blocks: each gathered over
    ``data``, then over ``model`` (blocks in coordinate order); a leaf is
    never split over ``pod``."""
    def gather(x, spec):
        for axis in ("data", "model"):
            dim = axis_dim(spec, axis)
            if dim is not None:
                x = _gather(x, dim, mesh.axis_group(axis))
        return x
    return tree_map(gather, local_tree, spec_tree)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = g.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),)
                        + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    # contiguous in the leaf's own layout: a sum over the block (the grad
    # norm) then adds in the one-process step's order
    return out.movedim(0, dim).contiguous()


def reduce_tree(grads, spec_tree, mesh: Mesh, batch_axes: Tuple[str, ...]):
    """The gradients of a step whose batch is split over ``batch_axes``
    (``()`` where every process computed the whole batch) summed over
    them, in place: a leaf split over ``data`` is already its block summed
    over ``data`` (``gather_data``'s backward) and is all-reduced over the
    other batch axes (``pod``); a leaf that every ``data`` process holds
    whole is all-reduced over the batch's group."""
    rest = tuple(a for a in batch_axes if a != "data")

    def reduce(g, spec):
        axes = rest if data_dim(spec) is not None else batch_axes
        if axes:
            dist.all_reduce(g, op=dist.ReduceOp.SUM,
                            group=axes_group(mesh, axes))
        return g
    return tree_map(reduce, grads, spec_tree)


def global_norm(leaves, specs, mesh: Mesh) -> torch.Tensor:
    """√(Σ g²) in f32 over a list of blocks and their specs: each leaf's
    Σ g² is its block's sum added over the group of every axis that splits
    it; over an axis that does not, the sum is the same on every process
    and counts once.  The leaves' sums are then added in order, as the
    one-process step adds them."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves]
    for axis in ("pod", "data", "model"):
        split = [i for i, spec in enumerate(specs)
                 if axis_dim(spec, axis) is not None]
        if split:
            total = torch.stack([sq[i] for i in split])
            dist.all_reduce(total, op=dist.ReduceOp.SUM,
                            group=mesh.axis_group(axis))
            for j, i in enumerate(split):
                sq[i] = total[j]
    return torch.sqrt(sum(sq))


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` summed over the group (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.dim, ctx.group), None, None


def _release(nbytes: int) -> None:
    with _gathered_lock:
        gathered["live"] -= nbytes


def gather_data(x: torch.Tensor, dim: int, group,
                summed: bool) -> torch.Tensor:
    """A param block (split over ``data`` along ``dim``) gathered whole
    over the ``data`` group for one use.  Backward, the block's gradient:
    where each process computed its own rows of the batch (``summed``),
    the sum of every process's gradient of the whole (a reduce-scatter);
    where every process computed the whole batch, its block of the (equal)
    whole gradient.  Counted in ``gathered``: the tensor's bytes stay
    ``live`` until its storage is freed (also where remat's recompute
    holds it through a detached alias)."""
    y = (_GatherBlocks if summed else _GatherModel).apply(x, dim, group)
    nbytes = y.numel() * y.element_size()
    with _gathered_lock:
        gathered["calls"] += 1
        gathered["bytes"] += nbytes
        gathered["live"] += nbytes
        gathered["peak"] = max(gathered["peak"], gathered["live"])
    weakref.finalize(y.untyped_storage(), _release, nbytes)
    return y


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's rows of ``x`` (dimension 0), in rank order; the
    gradient of each process's rows is the sum of every process's gradient
    for them (a reduce-scatter)."""
    return _GatherBlocks.apply(x, 0, group)


def gather_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A leaf's blocks along ``dim`` gathered whole over the group, for a
    computation that each process runs on its own part of the whole: the
    gradient of each process's block is the sum of every process's
    gradient for it (a reduce-scatter), where ``gather_model`` takes the
    block of a gradient that is the same on every process."""
    counts["gather_blocks"] += 1
    return _GatherBlocks.apply(x, dim, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dy, op=dist.ReduceOp.SUM, group=ctx.group)
        return dy, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group, every process getting the sum, for a
    computation in which each process uses the sum on its own part (the
    outputs differ from process to process): backward, the gradient of
    each process's ``x`` is the sum of every process's gradient of the
    sum.  ``from_model`` is the case where every process's use is the
    same, and its gradient passes unchanged."""
    counts["psum"] += 1
    return _PSum.apply(x, group)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        # a copy: autograd may hand the same gradient to another branch
        dy = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dy, op=dist.ReduceOp.SUM, group=ctx.group)
        return dy, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # a copy: a saved product (remat's selective policy) must not change
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, a replicated activation, entering a computation split over
    the model group: the same tensor forward; backward, its gradient is
    the sum of every model process's (each has its own block's part)."""
    counts["to_model"] += 1
    return _ToModel.apply(x, group)


def from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A split computation's partial output, summed over the model group
    (every process gets the whole); backward, each process's gradient is
    the whole one, unchanged."""
    counts["from_model"] += 1
    return _FromModel.apply(x, group)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        k = dy.shape[ctx.dim] // dist.get_world_size(ctx.group)
        at = dist.get_rank(ctx.group) * k
        return dy.narrow(ctx.dim, at, k).contiguous(), None, None


def gather_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A leaf's blocks along ``dim`` gathered whole over the model group,
    for a computation that every model process runs whole and alike; the
    gradient, whole and the same on every process, gives each its block."""
    return _GatherModel.apply(x, dim, group)
