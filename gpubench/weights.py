"""The seeded weights and inputs that the benchmark hands both sides.

Weights are made on the card from ``--seed``, one generator and one call
for each stacked leaf (a leaf holds every layer's tensor), in the dtype
they are served in.  Matrices are N(0, 1/fan_in) over their contracting
dimensions, norm gains and Mamba-2's skip are ones, and Mamba-2's ``A`` and
``dt`` follow its published initialisation (A in [1, 16], dt log-uniform
in [1e-3, 1e-1]).  The leaves and their nesting are the program's param
tree; the reference reads the same leaves by the same names.  Each leaf
can be made again alone (``leaf``), so a check can rebuild the initial
weights one leaf at a time after the program has updated its own in place.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from .reference.families import family

# "normal" (std given), ones, and Mamba-2's A and dt as published
INITS = ("normal", "ones", "a_log", "dt_bias")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# A stream of seeds for the leaves and the data, apart for every --seed.
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def sub_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + (index + 1) * _MIX) & _MASK


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(dotted name, shape, init, std) of every leaf, in a fixed order, as
    the configuration's family gives them (``reference/families``).
    ``init`` is one of ``INITS``."""
    return family(cfg).leaves(cfg)


def leaf(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of ``leaf_specs`` as made for ``seed``, in the
    configuration's param dtype."""
    _, shape, init, std = leaf_specs(cfg)[index]
    dtype = DTYPES[cfg["param_dtype"]]
    g = torch.Generator(device).manual_seed(sub_seed(seed, index))
    if init == "normal":
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(std)
    if init == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    if init not in INITS:
        raise ValueError(f"no initialisation {init!r}")
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    if init == "a_log":
        return torch.log(1.0 + 15.0 * u).to(dtype)
    # dt log-uniform in [1e-3, 1e-1], dt_bias its inverse softplus
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for name, x in flat.items():
        node = out
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = x
    return out


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        name = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(flatten(tree[k], name + "."))
        else:
            out[name] = tree[k]
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The whole param tree for ``seed``."""
    return nest({name: leaf(cfg, seed, i, device)
                 for i, (name, *_) in enumerate(leaf_specs(cfg))})


def units(name: str, x: torch.Tensor) -> Iterator[Tuple[str, torch.Tensor]]:
    """The tensors that the checks compare one by one: each layer's slice
    of a stacked leaf, and every other leaf whole."""
    if name.startswith("layers."):
        for i in range(x.shape[0]):
            yield f"{name}[{i}]", x[i]
    else:
        yield name, x


def unit_norms(name: str, x: torch.Tensor) -> Dict[str, float]:
    """The f64 norm of each of a leaf's units."""
    return {u: float(t.double().norm()) for u, t in units(name, x)}


def token_batches(seed: int, stream: int, count: int, batch: int,
                  length: int, vocab: int, device) -> torch.Tensor:
    """(count, batch, length) token ids, uniform over the vocabulary, from
    a generator of their own on the card (``stream`` keeps the data of two
    uses of one seed apart)."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, 10_000 + stream))
    return torch.randint(0, vocab, (count, batch, length), generator=g,
                         device=device, dtype=torch.int32)
