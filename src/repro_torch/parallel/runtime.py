"""Running a mesh's ``data`` axis: one process a device, in a
``torch.distributed`` group, and the collectives that move a tree between
its whole form and the blocks its processes hold.

The JAX package has no module like this one: under ``jax.jit`` with
``in_shardings`` XLA's partitioner inserts the all-gathers and
reduce-scatters itself.  Here the train step calls them (``train/step.py``):

* ``shard_tree`` keeps this process's block of each tensor of a whole tree;
* ``gather_tree`` all-gathers the blocks back into whole tensors;
* ``reduce_tree`` sums each whole gradient over the processes into this
  process's block (a reduce-scatter), or whole where the leaf is
  replicated (an all-reduce);
* ``global_norm`` is √(Σ g²) over a tree of blocks: a split leaf's blocks
  add up across the processes, a replicated leaf counts once;
* ``gather_rows`` is a differentiable all-gather of batch rows (the MoE
  routes the whole batch's tokens, as one device does).  It stands where
  ``torch.distributed.nn.functional.all_gather`` would: that one is
  deprecated in torch 2.13, and its backward takes another collective on
  each backend (a reduce-scatter on NCCL, an all-to-all and a stacked sum
  on gloo); this one is the same two collectives on both.

A leaf is split when its spec names ``data`` (``spec_for``'s FSDP rule),
whatever the axis's size: at one process each collective is a copy, so a
group of one runs the same code as a group of many.  The ``model`` axis is
not executed (``check_executable``).  The collectives are
``all_gather_into_tensor`` and ``reduce_scatter_tensor``, which both the
gloo and the NCCL backends run; a dimension other than 0 is moved to the
front first.
"""

from __future__ import annotations

import os
import warnings
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


def check_executable(mesh: Mesh) -> None:
    """Raise unless the mesh's processes can run it: one process a device,
    and no axis but ``data`` larger than 1."""
    n = dist.get_world_size(mesh.group)
    if n != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} devices in a group of {n} "
                         "processes")
    wide = {a: s for a, s in mesh.shape.items() if a != "data" and s > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: only the data axis is executed; tensor and "
            "expert parallelism over the model axis are ROADMAP item 16")


def rank(mesh: Mesh) -> int:
    """This process's rank in the mesh's group; 0 on a mesh without one."""
    return 0 if mesh.group is None else dist.get_rank(mesh.group)


def barrier(mesh: Mesh) -> None:
    """Wait for every process of the mesh's group; nothing without one."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def coords(mesh: Mesh):
    return mesh_coords(mesh, rank(mesh))


def data_dim(spec: PartitionSpec) -> Optional[int]:
    """The dimension a spec splits over ``data``, or None (replicated)."""
    for i, entry in enumerate(spec):
        if "data" in spec_axes(entry):
            return i
    return None


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


def gather_tree(local_tree, spec_tree, mesh: Mesh):
    """The whole tensors from every process's blocks: an all-gather along
    each split dimension, blocks in rank order.  A replicated leaf is
    returned as it is."""
    def gather(x, spec):
        dim = data_dim(spec)
        return x if dim is None else _gather(x, dim, mesh.group)
    return tree_map(gather, local_tree, spec_tree)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = g.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),)
                        + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    # contiguous in the leaf's own layout: a sum over the block (the grad
    # norm) then adds in the one-process step's order
    return out.movedim(0, dim).contiguous()


def reduce_tree(grads, spec_tree, mesh: Mesh):
    """Each process's whole gradients summed over the processes: into this
    process's block where the leaf is split (a reduce-scatter), whole where
    it is replicated (an all-reduce, in place)."""
    def reduce(g, spec):
        dim = data_dim(spec)
        if dim is not None:
            return _reduce_scatter(g, dim, mesh.group)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.group)
        return g
    return tree_map(reduce, grads, spec_tree)


def global_norm(leaves, specs, mesh: Mesh) -> torch.Tensor:
    """√(Σ g²) in f32 over a list of blocks and their specs: each leaf's
    Σ g² is its blocks' sums added over the processes where it is split,
    its own where it is replicated (the same on every process: counted
    once); the leaves' sums are then added in order, as the one-process
    step adds them."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves]
    split = [i for i, spec in enumerate(specs) if data_dim(spec) is not None]
    if split:
        total = torch.stack([sq[i] for i in split])
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
        for j, i in enumerate(split):
            sq[i] = total[j]
    return torch.sqrt(sum(sq))


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` summed over the group (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, 0, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, 0, ctx.group), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's rows of ``x`` (dimension 0), in rank order; the
    gradient of each process's rows is the sum of every process's gradient
    for them (a reduce-scatter)."""
    return _GatherRows.apply(x, group)
