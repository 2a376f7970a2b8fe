"""Mesh construction: the production shapes, and the host's processes.

Each mesh is a ``parallel.sharding.Mesh`` descriptor (axis names and
sizes, and the type of device): building one touches no device state,
and the production meshes (256 and 512 devices) exist only on paper, for
the dry-run.  The host mesh runs: it carries the default process group,
one process a device (``parallel.runtime``), and a subgroup for each of
its axes.
"""

from __future__ import annotations

import torch.distributed as dist

from ..device import resolve_device
from ..parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def _axis_groups(n: int, model: int):
    """{"data": the processes that share this one's model coordinate,
    "model": those that share its data coordinate}: process r sits at
    (r // model, r % model).  Every process creates every subgroup, in the
    same order, as ``dist.new_group`` requires; a subgroup of every
    process is the default group itself."""
    me = dist.get_rank()
    out = {}
    for axis, members in (
            ("data", [[d * model + j for d in range(n // model)]
                      for j in range(model)]),
            ("model", [[d * model + j for j in range(model)]
                       for d in range(n // model)])):
        for ranks in members:
            group = (dist.group.WORLD if len(ranks) == n
                     else dist.new_group(ranks))
            if me in ranks:
                out[axis] = group
    return out


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the processes of the default process
    group, one device each, which carries the group and a subgroup for
    each axis (``Mesh.axis_group``); with no group, the one device of this
    process, (1, 1), which plans and does not run across processes.  The
    JAX package's spans the local devices of one process; here a process
    drives one device, so a host of n cards runs n processes (torchrun)
    and its mesh is (n / model, model)."""
    dev = resolve_device(device)
    group = dist.group.WORLD if dist.is_initialized() else None
    n = dist.get_world_size() if group is not None else 1
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    axis_groups = None if group is None else _axis_groups(n, model)
    return Mesh(("data", "model"), (n // model, model), dev.type, group,
                axis_groups)
