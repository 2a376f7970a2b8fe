"""Mesh construction: the production shapes, and the host's processes.

Each mesh is a ``parallel.sharding.Mesh`` descriptor (axis names and
sizes, and the type of device): building one touches no device state,
and the production meshes (256 and 512 devices) exist only on paper, for
the dry-run.  The host mesh runs: it carries the default process group,
one process a device (``parallel.runtime``), and a subgroup for each of
its axes (and, with a ``pod`` axis, one for the batch's two).
"""

from __future__ import annotations

import torch.distributed as dist

from ..device import resolve_device
from ..parallel.sharding import Mesh, mesh_coords


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def _axis_groups(mesh: Mesh):
    """{axis: the group of the processes that share this one's coordinates
    on every other axis}, for each axis of ``mesh``, and on a mesh with a
    ``pod`` axis also {("pod", "data"): those that share its ``model``
    coordinate} (the batch's group).  Each group's processes are in rank
    order, which is row-major over its axes' coordinates.  Every process
    creates every subgroup, in the same order, as ``dist.new_group``
    requires; a subgroup of every process is the default group itself."""
    me, n = dist.get_rank(), dist.get_world_size()
    out = {}
    keys = [(a,) for a in mesh.axis_names]
    if "pod" in mesh.axis_names:
        keys.append(("pod", "data"))
    for axes in keys:
        members = {}
        for r in range(n):
            at = mesh_coords(mesh, r)
            members.setdefault(tuple(at[a] for a in mesh.axis_names
                                     if a not in axes), []).append(r)
        for ranks in members.values():
            group = (dist.group.WORLD if len(ranks) == n
                     else dist.new_group(ranks))
            if me in ranks:
                out[axes[0] if len(axes) == 1 else axes] = group
    return out


def make_host_mesh(model: int = 1, pod: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the processes of the default process
    group, one device each, or with ``pod`` > 1 a (pod, data, model) mesh,
    which carries the group and a subgroup for each axis
    (``Mesh.axis_group``) and, with a ``pod`` axis, one for the batch's
    (pod, data); with no group, the one device of this process, (1, 1),
    which plans and does not run across processes.  The JAX package's
    spans the local devices of one process; here a process drives one
    device, so a host of n cards runs n processes (torchrun) and its mesh
    is (n / model, model), or (pod, n / (pod · model), model)."""
    dev = resolve_device(device)
    group = dist.group.WORLD if dist.is_initialized() else None
    n = dist.get_world_size() if group is not None else 1
    if n % (model * pod):
        raise ValueError(f"{n} devices do not split into pod={pod}, "
                         f"model={model}")
    names, sizes = ("data", "model"), (n // model, model)
    if pod > 1:
        names, sizes = ("pod",) + names, (pod, n // (pod * model), model)
    plan = Mesh(names, sizes, dev.type)
    if group is None:
        return plan
    return Mesh(names, sizes, dev.type, group, _axis_groups(plan))
