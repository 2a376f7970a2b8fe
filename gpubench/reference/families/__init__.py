"""The model families of the plain reference, one module a family, found
by a configuration's ``family`` key as ``families/<family>.py``.  A later
change adds a family by adding its module, and edits no file that is
there.

Each module gives:

* ``leaves(cfg)``: (dotted name, shape, init, std) of every leaf of the
  program's param tree, in a fixed order (``gpubench.weights`` makes them;
  ``init`` is one of ``weights.INITS``);
* ``hidden(w, tokens, cfg, prec)``: the last layer's output after the final
  norm, f32, from {leaf name: f32 tensor} and (B, S) token ids;
* ``matrix_params(cfg)``: the parameters of the model's products, the
  unembedding included and the embedding (a lookup) not;
* ``mixer_flops(cfg, batch, seq, train)``: the flops of a step's sequence
  mixing that no parameter's product counts (attention's scores, a scan).
"""

from __future__ import annotations

import importlib
from typing import List, Tuple

Leaf = Tuple[str, tuple, str, float]


def family(cfg: dict):
    """The module of the configuration's family."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")


def stacked(cfg: dict, top: List[Leaf], layer: List[Leaf]) -> List[Leaf]:
    """The leaves of a language model: the embedding, ``top`` (its
    final norm's), the unembedding, and each of ``layer``'s leaves stacked
    over ``cfg["n_layers"]`` layers."""
    d, v = cfg["d_model"], cfg["vocab"]
    out = [("embed", (v, d), "normal", 1.0), *top,
           ("unembed", (d, v), "normal", d ** -0.5)]
    return out + [("layers." + name, (cfg["n_layers"],) + shape, init, std)
                  for name, shape, init, std in layer]
