"""Weights from the JAX package: a param tree given as numpy arrays
(``jax.tree.map(np.asarray, params)``) becomes this package's nested dict
of tensors, with the same names, shapes and axis order."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_numpy(tree, device="cuda", dtype=None):
    """Copy a nested dict of numpy arrays onto ``device``, optionally cast
    to ``dtype``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev, dtype=dtype)
