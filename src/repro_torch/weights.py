"""Weights from the JAX package: a param tree given as numpy arrays
(``jax.tree.map(np.asarray, params)``) becomes this package's nested dict
of tensors, with the same names, shapes and axis order."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .parallel import runtime
from .parallel.sharding import local_slice, tree_map


def params_from_numpy(tree, device="cuda", dtype=None):
    """Copy a nested dict of numpy arrays onto ``device``, optionally cast
    to ``dtype``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev, dtype=dtype)


def params_from_numpy_sharded(tree, spec_tree, mesh, device="cuda"):
    """This process's blocks of a whole tree of numpy arrays on a mesh that
    runs (``parallel.runtime``): each leaf's block by its spec, copied onto
    ``device``; nothing else is copied."""
    dev = resolve_device(device)
    at = runtime.coords(mesh)
    return tree_map(lambda x, spec: torch.tensor(
        np.ascontiguousarray(np.asarray(x)[local_slice(np.shape(x), spec,
                                                       mesh, at)]),
        device=dev), tree, spec_tree)
