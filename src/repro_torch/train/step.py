"""Train, prefill and decode step builders, for one card.

Each builder returns the step function and its inputs as ``device="meta"``
tensors (shapes and dtypes, no storage), as the JAX builders return
abstract ``ShapeDtypeStruct``s.  The builder's ``device`` is where the step
puts the batch, lengths and tokens it is given (numpy arrays or tensors);
params, optimizer state and cache must already be there (``"meta"`` runs
the step on meta tensors: shapes only, as the dry-run does).  The train
step takes its gradients with autograd in place of ``jax.value_and_grad``,
accumulates microbatches with a Python loop in place of ``lax.scan``, and
updates params and moments in place (``optimizer.apply_updates``).

Given a ``mesh`` (a ``parallel.sharding.Mesh``), a step runs under
``activation_rules(mesh, rules)``, as the JAX steps do, and its model's
``constrain`` calls check their axes against it; nothing is split (the
port has no SPMD partitioner).  The placements the JAX builders return as
``in_shardings``/``out_shardings`` come from ``step_specs``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..models import get_model
from ..models.config import ModelConfig
from ..models.modules import ParamSpec
from ..parallel.ctx import activation_rules
from ..parallel.sharding import (Mesh, PartitionSpec as P, Rules,
                                 default_rules, spec_for, tree_specs)
from .optimizer import (AdamWConfig, apply_updates, init_state,
                        tree_leaves, tree_unflatten)

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    # int8 DP all-reduce (parallel.collectives.int8_allreduce).  Declared,
    # and read by nothing, in both packages (ROADMAP F16): the step is the
    # same with it on.
    grad_compression: bool = False


def _meta_params(tree, dtype):
    if isinstance(tree, ParamSpec):
        return torch.empty(tree.shape, dtype=dtype, device=META)
    return {k: _meta_params(v, dtype) for k, v in tree.items()}


def _rules_scope(mesh: Optional[Mesh], rules: Optional[Rules]):
    """The JAX steps' ``activation_rules`` scope, or none without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return activation_rules(mesh, rules or default_rules(mesh))


def batch_specs(cfg: ModelConfig, batch_abstract: Dict, rules: Rules,
                mesh: Mesh):
    out = {}
    for k, v in batch_abstract.items():
        axes = ["batch"] + [None] * (len(v.shape) - 1)
        out[k] = spec_for(tuple(v.shape), tuple(axes), rules, mesh)
    return out


def make_batch_abstract(cfg: ModelConfig, global_batch: int, seq: int
                        ) -> Dict[str, torch.Tensor]:
    b, s = global_batch, seq
    batch: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "none":
        batch["tokens"] = torch.empty((b, s), dtype=torch.int32, device=META)
    else:
        batch["frames"] = torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    pos_shape = (b, s, 3) if cfg.rope == "mrope" else (b, s)
    batch["positions"] = torch.empty(pos_shape, dtype=torch.int32,
                                     device=META)
    batch["targets"] = torch.empty((b, s), dtype=torch.int32, device=META)
    return batch


def build_train_step(cfg: ModelConfig, global_batch: int, seq: int,
                     tc: Optional[TrainConfig] = None, device="cuda",
                     mesh: Optional[Mesh] = None,
                     rules: Optional[Rules] = None):
    """Returns (train_step, (params, opt_state, batch) as meta tensors);
    ``train_step(params, opt_state, batch)`` returns (params, opt_state,
    {"loss", "grad_norm"}), both f32 scalars on the device, params and
    moments updated in place.  With ``tc.microbatches`` = m > 1 the batch is
    split as the JAX step splits it (reshaped to (m, B/m, ...)), the f32
    gradients and the losses of the m parts are summed, then divided by m.
    ``grad_norm`` is sqrt(Σ g²) in f32 over every leaf."""
    tc = tc or TrainConfig()
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    opt_abs = init_state(params_abs, tc.adamw)
    batch_abs = make_batch_abstract(cfg, global_batch, seq)
    m = tc.microbatches

    def value_and_grad(params, batch):
        # A leaf the loss does not read (olmo's norm gains: its LayerNorm
        # has none) gets a zero gradient, as under jax.value_and_grad.
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = model.loss_fn(tree_unflatten(params, leaves), batch, cfg)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def train_step(params, opt_state, batch):
        with _rules_scope(mesh, rules):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if m > 1:
            acc, loss = None, torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(m):
                part = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                        for k, v in batch.items()}
                part_loss, g = value_and_grad(params, part)
                g = [x.float() for x in g]
                acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
                loss = loss + part_loss
            grads = [a / m for a in acc]
            loss = loss / m
        else:
            loss, grads = value_and_grad(params, batch)
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
        with record_function("adamw"):
            params, opt_state = apply_updates(
                params, tree_unflatten(params, grads), opt_state, tc.adamw)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return train_step, (params_abs, opt_abs, batch_abs)


def build_prefill_step(cfg: ModelConfig, global_batch: int, seq: int,
                       device="cuda", mesh: Optional[Mesh] = None,
                       rules: Optional[Rules] = None):
    """Returns (prefill_step, (params, batch) as meta tensors);
    ``prefill_step(params, batch)`` gives the last token's logits (B, V)."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    batch_abs = make_batch_abstract(cfg, global_batch, seq)
    batch_abs.pop("targets")

    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad(), _rules_scope(mesh, rules):
            logits = model.forward(params, batch, cfg)
        # serving returns last-token logits only (sampler input)
        return logits[:, -1, :]

    return prefill_step, (params_abs, batch_abs)


def cache_axes(cfg: ModelConfig):
    if cfg.family == "ssm":
        return {"conv": ("layers", "batch", "conv_k", "inner_conv"),
                "ssm": ("layers", "batch", "ssm_heads", "head_dim",
                        "ssm_state")}
    if cfg.family == "hybrid":
        return {"kv": ("layers", "kv2", "batch", "cache_seq", "kv_heads",
                       "head_dim"),
                "conv": ("layers", "layers2", "batch", "conv_k",
                         "inner_conv"),
                "ssm": ("layers", "layers2", "batch", "ssm_heads",
                        "head_dim", "ssm_state")}
    return ("layers", "kv2", "batch", "cache_seq", "kv_heads", "head_dim")


def build_decode_step(cfg: ModelConfig, global_batch: int, max_seq: int,
                      device="cuda", mesh: Optional[Mesh] = None,
                      rules: Optional[Rules] = None):
    """One-token serve_step against a max_seq KV cache (or, for the SSM
    family, the O(1) conv and SSM state; ``max_seq`` is then not used).
    Returns (serve_step, (params, cache, lengths, tokens) as meta tensors);
    ``serve_step`` returns (logits (B, 1, V), cache), the cache updated in
    place."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    if cfg.family == "ssm":
        cache_abs = model.init_cache(cfg, global_batch, device=META)
    else:
        cache_abs = model.init_cache(cfg, global_batch, max_seq, device=META)
    lengths_abs = torch.empty((global_batch,), dtype=torch.int32,
                              device=META)
    tokens_abs = torch.empty((global_batch, 1), dtype=torch.int32,
                             device=META)

    def serve_step(params, cache, lengths, tokens):
        with torch.no_grad(), _rules_scope(mesh, rules):
            return model.decode_step(
                params, cache, torch.as_tensor(lengths, device=dev),
                torch.as_tensor(tokens, device=dev), cfg)

    return serve_step, (params_abs, cache_abs, lengths_abs, tokens_abs)


def step_specs(cfg: ModelConfig, kind: str, mesh: Mesh, global_batch: int,
               seq: int, tc: Optional[TrainConfig] = None,
               rules: Optional[Rules] = None):
    """(in_specs, out_specs): the placements of a step's inputs and outputs
    on ``mesh``, as trees of ``PartitionSpec`` shaped like its arguments
    and results: the ``.spec`` of each ``NamedSharding`` in the JAX
    builders' ``in_shardings`` and ``out_shardings``.  ``kind`` is "train",
    "prefill" or "decode" (``seq`` is then the cache's ``max_seq``)."""
    rules = rules or default_rules(mesh)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    p_spec = tree_specs(params_abs, model.logical_axes(cfg), rules, mesh)
    if kind == "train":
        batch_abs = make_batch_abstract(cfg, global_batch, seq)
        opt_spec = {"mu": p_spec, "nu": p_spec, "count": P()}
        return ((p_spec, opt_spec, batch_specs(cfg, batch_abs, rules, mesh)),
                (p_spec, opt_spec, {"loss": P(), "grad_norm": P()}))
    if kind == "prefill":
        batch_abs = make_batch_abstract(cfg, global_batch, seq)
        batch_abs.pop("targets")
        return ((p_spec, batch_specs(cfg, batch_abs, rules, mesh)),
                spec_for((global_batch, cfg.vocab), ("batch", "vocab"),
                         rules, mesh))
    if kind != "decode":
        raise ValueError(f"unknown step kind {kind!r}")
    _, (_, cache_abs, _, _) = build_decode_step(cfg, global_batch, seq,
                                                device="meta")
    ca = cache_axes(cfg)
    if isinstance(cache_abs, dict):
        c_spec = {k: spec_for(tuple(v.shape), ca[k], rules, mesh)
                  for k, v in cache_abs.items()}
    else:
        c_spec = spec_for(tuple(cache_abs.shape), ca, rules, mesh)
    l_spec = spec_for((global_batch,), ("batch",), rules, mesh)
    t_spec = spec_for((global_batch, 1), ("batch", None), rules, mesh)
    logits_spec = spec_for((global_batch, 1, cfg.vocab),
                           ("batch", None, "vocab"), rules, mesh)
    return (p_spec, c_spec, l_spec, t_spec), (logits_spec, c_spec)
