"""Logical-axis sharding rules (MaxText-style), as the JAX package states
them.

Parameters, activations and caches carry *logical* axis names; a rule
table maps them to mesh axes.  Assignment is divisibility-checked per
tensor: a logical axis whose dimension does not divide the mesh axis size
falls back to replication (e.g. kv_heads=8 on a 16-way model axis).

Default parallelism:
  batch        → (pod, data)   data parallelism across pods
  heads/mlp/vocab/expert → model   tensor / expert parallelism
  embed        → data          FSDP: weights+optimizer sharded over DP
  cache_seq    → model (decode_32k) or (data, model) (long_500k)

``spec_for`` reads only a mesh's axis names and sizes, so the mesh here is
``Mesh``, a frozen descriptor of its own, not a ``torch.distributed``
``DeviceMesh``: a ``DeviceMesh`` needs a process group of the mesh's size,
which the 256- and 512-device dry-run never has.  A mesh that carries a
process group (``launch.mesh.make_host_mesh`` in a group) is one that runs:
its member of rank r sits at coordinate ``mesh_coords(mesh, r)``, and holds
``local_slice`` of each tensor.  A spec is ``PartitionSpec``, a tuple of
mesh-axis entries (an axis name, a tuple of names, or None) with trailing
Nones trimmed, as ``jax.sharding.PartitionSpec`` holds them.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, Dict, Optional, Tuple, Union

Rules = Dict[str, Union[str, Tuple[str, ...], None]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as ``spec_for`` sees it: axis names and sizes, and the
    type of device its members are (``"cuda"``, ``"cpu"``, or ``"meta"``
    for a mesh that exists only on paper, as the dry-run's), and the
    process group that runs it, if any."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_type: str = "meta"
    # the torch.distributed group of the mesh's processes, one a device, in
    # the order of their coordinates; None for a mesh that only plans
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    # on a mesh that runs, {axis: the group of the processes that share
    # this process's coordinates on every other axis}, in the order of
    # their coordinate on that axis
    axis_groups: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_group(self, axis: str):
        """The group along ``axis`` that this process is in (a mesh that
        runs only)."""
        return self.axis_groups[axis]

    @property
    def devices(self):
        # jax.sharding.Mesh.devices is an array; its .size is what callers
        # read
        return types.SimpleNamespace(size=self.size)


class PartitionSpec(tuple):
    """One tensor's placement: entry i is the mesh axis (or tuple of axes)
    dimension i is split over, or None; trailing Nones are trimmed."""

    def __new__(cls, *entries):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def default_rules(mesh: Mesh) -> Rules:
    has_pod = "pod" in mesh.axis_names
    batch_axes = ("pod", "data") if has_pod else ("data",)
    return {
        "batch": batch_axes,
        "seq": None,
        "embed": "data",          # FSDP for params/optimizer state
        "vocab_in": "model",      # embedding table (gather source)
        "embed_in": "data",
        "embed2": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "vocab": "model",
        "layers": None,
        "inner": "model",
        "inner_all": "model",
        "inner_conv": None,
        "conv_k": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "layers2": None,
        "kv2": None,
        "cache_seq": "model",
        "pages": "data",
        "act_embed": None,
        "act_batch": batch_axes,
    }


def long_context_rules(mesh: Mesh) -> Rules:
    """long_500k: batch=1 — shard the KV cache sequence over everything."""
    r = default_rules(mesh)
    r["batch"] = None
    r["act_batch"] = None
    has_pod = "pod" in mesh.axis_names
    r["cache_seq"] = ("pod", "data", "model") if has_pod \
        else ("data", "model")
    return r


def _axis_size(mesh: Mesh, axis: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(axis, str):
        return mesh.shape[axis]
    n = 1
    for a in axis:
        n *= mesh.shape[a]
    return n


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             rules: Rules, mesh: Mesh) -> PartitionSpec:
    """PartitionSpec for one tensor, divisibility-checked; a mesh axis is
    used at most once per tensor (first logical dim wins)."""
    assert len(shape) == len(axes), (shape, axes)
    used = set()
    entries = []
    for dim, ax in zip(shape, axes):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            entries.append(None)
            continue
        taxes = (target,) if isinstance(target, str) else tuple(target)
        taxes = tuple(a for a in taxes
                      if a in mesh.axis_names and a not in used)
        if not taxes or dim % _axis_size(mesh, taxes) != 0:
            entries.append(None)
            continue
        used.update(taxes)
        entries.append(taxes if len(taxes) > 1 else taxes[0])
    return PartitionSpec(*entries)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Tuple[int, ...], spec: PartitionSpec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` placed by
    ``spec`` (``NamedSharding.shard_shape``)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in spec_axes(entry))
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {entry} ({n})")
        out[i] //= n
    return tuple(out)


def mesh_coords(mesh: Mesh, index: int) -> Dict[str, int]:
    """The coordinate of the mesh's device ``index`` (a process's rank in
    the mesh's group), row-major over the axes: ``jax.make_mesh((n, 1))``
    puts device i at (i, 0)."""
    if not 0 <= index < mesh.size:
        raise ValueError(f"device {index} is not on a mesh of {mesh.size}")
    coords = {}
    for name, size in reversed(tuple(zip(mesh.axis_names, mesh.axis_sizes))):
        index, coords[name] = divmod(index, size)
    return {name: coords[name] for name in mesh.axis_names}


def local_slice(shape: Tuple[int, ...], spec: PartitionSpec, mesh: Mesh,
                coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index block of a tensor of ``shape`` placed by ``spec`` that the
    device at ``coords`` holds: along a dimension split over axes (a, b, ...)
    the blocks are contiguous and numbered row-major over those axes'
    coordinates, as ``NamedSharding`` numbers them.  Its shape is
    ``shard_shape(shape, spec, mesh)``."""
    block = shard_shape(shape, spec, mesh)
    out = [slice(None)] * len(shape)
    for i, entry in enumerate(spec):
        at = 0
        for a in spec_axes(entry):
            at = at * mesh.shape[a] + coords[a]
        if spec_axes(entry):
            out[i] = slice(at * block[i], (at + 1) * block[i])
    return tuple(out)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (tuples are leaves, as a
    logical-axes tuple is); ``rest`` are trees of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_specs(abstract_tree, axes_tree, rules: Rules, mesh: Mesh):
    """PartitionSpec tree for a tree of tensors (meta or not) or anything
    else with a ``.shape``."""
    return tree_map(lambda leaf, axes: spec_for(tuple(leaf.shape), axes,
                                                rules, mesh),
                    abstract_tree, axes_tree)


def tree_shardings(abstract_tree, axes_tree, rules: Rules, mesh: Mesh):
    """The JAX package's ``tree_shardings`` gives a tree of
    ``NamedSharding(mesh, spec)``; the port has no sharded arrays, so its
    placements are the spec tree itself, with the mesh beside it."""
    return tree_specs(abstract_tree, axes_tree, rules, mesh)
