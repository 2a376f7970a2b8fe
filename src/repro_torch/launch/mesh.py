"""Mesh construction: the production shapes, and the local devices.

Each mesh is a ``parallel.sharding.Mesh`` descriptor (axis names and
sizes, and the type of device): building one touches no device state,
and the production meshes (256 and 512 devices) exist only on paper, for
the dry-run.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the local devices: every visible card, or
    one CPU device when ``device`` is the CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return Mesh(("data", "model"), (n // model, model), dev.type)
