"""AdamW, with the JAX package's arithmetic.

Every leaf is decayed, norm gains included; the bias corrections are taken
in f32 from an int32 step count; moments are kept in ``moment_dtype`` and
the update is computed in f32.  The state lives on the params' device.

Unlike the JAX package, whose arrays are immutable, ``apply_updates``
updates the params and the moments in place under ``torch.no_grad()`` and
returns the same trees: at full olmo-1b width a second copy of the f32
params would take another 5.1 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.float32


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, keys in sorted order (the order
    ``jax.tree.flatten`` visits a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict shaped like ``like`` with ``leaves`` in
    ``tree_leaves`` order."""
    return _unflatten(like, iter(leaves))


def _unflatten(node, it):
    # not a closure: a recursive closure is a reference cycle that would
    # keep ``leaves`` (a step's gradients) alive until the cyclic collector
    # runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def clone_tree(tree):
    """A copy of a nested dict of tensors, each leaf cloned."""
    return tree_unflatten(tree, [x.clone() for x in tree_leaves(tree)])


def init_state(params, cfg: AdamWConfig) -> Dict:
    """Zero moments in ``cfg.moment_dtype`` and a zero int32 count, on the
    params' device (``meta`` params give meta state)."""
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [
            torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
            for p in leaves])
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig
                  ) -> Tuple[Any, Dict]:
    """One AdamW step.  Updates ``params``, ``state["mu"]`` and
    ``state["nu"]`` in place and returns (params, state) with a new
    ``count``."""
    count = state["count"] + 1
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32,
                             device=count.device) ** count.float()
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32,
                             device=count.device) ** count.float()

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * step)
        mu.copy_(mu32)
        nu.copy_(nu32)

    for leaves in zip(*(tree_leaves(t) for t in (params, grads, state["mu"],
                                                  state["nu"]))):
        upd(*leaves)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}
