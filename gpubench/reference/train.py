"""The reference's training steps: the next-token loss, its gradient by
autograd and AdamW, in f32, from the benchmark's weights and batches.

It follows a step of the program as the configuration states it: the
loss is the mean over every token of the global batch, and AdamW
(decoupled weight decay on every leaf, bias corrections from the step
count) updates the weights.  It reads what it compares as norms of each
unit (a layer's slice of a stacked leaf, or a whole leaf): the first
step's gradient, and the change of the weights over the steps it took.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .. import weights
from .models import Precision, hidden, logits, token_losses


def adamw(w: Dict[str, torch.Tensor], mu, nu, step: int, hp: dict) -> None:
    """One AdamW update of every leaf of ``w`` from its ``.grad``, in
    place."""
    b1, b2 = hp["b1"], hp["b2"]
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    with torch.no_grad():
        for name, p in w.items():
            g = p.grad
            mu[name].mul_(b1).add_(g, alpha=1.0 - b1)
            nu[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (mu[name] / c1) / ((nu[name] / c2).sqrt() + hp["eps"])
            p.sub_(hp["lr"] * (update + hp["weight_decay"] * p))


def train_steps(cfg: dict, hp: dict, seed: int, batches: List[torch.Tensor],
                prec: Optional[Precision] = None,
                rows: Optional[range] = None,
                reduce: Optional[Callable[[torch.Tensor], None]] = None,
                device="cuda") -> dict:
    """Take ``len(batches)`` steps from the weights of ``seed``.  Each batch
    is (B, S + 1) token ids: inputs and next-token targets.  The gradient
    of a step is summed over its rows, one row a pass so that memory stays
    in bounds; ``rows`` (default: all) and ``reduce`` (an in-place sum over the
    processes that share the batch) split a step's rows between processes.
    Returns {"loss": [each step's loss], "grad": {unit: the first step's
    gradient norm}, "change": {unit: the norm of the weights' change over
    the steps}}."""
    prec = prec or Precision.reference()
    specs = weights.leaf_specs(cfg)
    w = {name: weights.leaf(cfg, seed, i, device).float().requires_grad_()
         for i, (name, *_) in enumerate(specs)}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    out = {"loss": [], "grad": {}, "change": {}}
    for step, batch in enumerate(batches, start=1):
        total_tokens = batch.shape[0] * (batch.shape[1] - 1)
        mine = rows if rows is not None else range(batch.shape[0])
        loss = torch.zeros((), device=device)
        for p in w.values():
            p.grad = torch.zeros_like(p)
        for r in mine:
            t = batch[r:r + 1]
            h = hidden(w, t[:, :-1], cfg, prec)
            part = token_losses(logits(w, h, prec),
                                t[:, 1:]).sum() / total_tokens
            part.backward()
            loss += part.detach()
        if reduce is not None:
            reduce(loss)
            for p in w.values():
                reduce(p.grad)
        out["loss"].append(float(loss))
        if step == 1:
            for name, p in w.items():
                out["grad"].update(weights.unit_norms(name, p.grad))
        adamw(w, mu, nu, step, hp)
    del mu, nu
    with torch.no_grad():
        for i, (name, *_) in enumerate(specs):
            w0 = weights.leaf(cfg, seed, i, device).float()
            out["change"].update(weights.unit_norms(name, w[name] - w0))
            del w0
    return out
