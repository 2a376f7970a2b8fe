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
``constrain`` calls check their axes against it.  The placements the JAX
builders return as ``in_shardings``/``out_shardings`` come from
``step_specs``.  A mesh that only plans splits nothing.  On a mesh that
runs (one that carries a process group: ``make_host_mesh`` in a group),
the train and prefill steps execute its ``data`` and ``model`` axes as
the JAX steps under ``jax.jit(in_shardings=...)`` do: the batch split by
rows over ``data`` (over ``pod`` and ``data`` on a mesh with a ``pod``
axis), params and AdamW moments held as blocks over ``data`` and
``model`` (FSDP over ``data``, gathered one layer at a time where the
layer runs; heads, kv heads, FFN columns, experts, Mamba-2 heads and
vocabulary over ``model``) and replicated over ``pod``, and each layer
computing on its blocks (``_sharded_train_step``,
``_sharded_prefill_step``, ``models/modules``, ``models/ssm``).  So does
the decode step (``_sharded_decode_step``), with the KV cache split along
its sequence over the group ``cache_seq`` names and each token's
attention merged over it by log-sum-exp.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from .. import ranges
from ..device import resolve_device
from ..models import get_model
from ..models.config import ModelConfig
from ..models.modules import ParamSpec, cross_entropy_terms, vocab_split
from ..parallel import runtime
from ..parallel.ctx import SeqSplit, activation_rules
from ..parallel.sharding import (Mesh, PartitionSpec as P, Rules,
                                 default_rules, shard_shape, spec_axes,
                                 spec_for, tree_specs)
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


def _runs(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` runs across processes (it carries a group)."""
    return mesh is not None and mesh.group is not None


def _batch_rows(spec, mesh: Mesh, global_batch: int, parts: int = 1):
    """(the mesh axes that split the batch, ``()`` where it is whole; the
    rows of each of ``parts`` parts this process takes; the first of them
    within a part), from the spec of a tensor whose rows are the
    batch's.  The rows split over ``data``, or over ``pod`` and ``data``,
    by the coordinate row-major over those axes, as ``spec_for`` lays
    them out.  Where the global batch does not divide, ``spec_for``
    replicates it, as JAX does, and every process takes every row; the
    ``model`` processes of one batch coordinate take the same rows."""
    axes = spec_axes(spec[0]) if len(spec) else ()
    at, n = _block_of(mesh, axes)
    if global_batch % (parts * n):
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"into {parts} microbatches over {n} processes")
    rows = global_batch // (parts * n)
    return axes, rows, at * rows


def _block_of(mesh: Mesh, axes):
    """(this process's block, the number of blocks) of a dimension split
    over ``axes``: blocks numbered row-major over the axes' coordinates,
    as ``local_slice`` numbers them."""
    at, n = 0, 1
    here = runtime.coords(mesh)
    for a in axes:
        at, n = at * mesh.shape[a] + here[a], n * mesh.shape[a]
    return at, n


def _batch_group(mesh: Mesh, axes):
    """The group of the processes that split the batch over ``axes``, or
    None where it is whole."""
    return runtime.axes_group(mesh, axes) if axes else None


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
    ``grad_norm`` is sqrt(Σ g²) in f32 over every leaf.  On a mesh that
    runs, see ``_sharded_train_step``."""
    tc = tc or TrainConfig()
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    opt_abs = init_state(params_abs, tc.adamw)
    batch_abs = make_batch_abstract(cfg, global_batch, seq)
    abstract = (params_abs, opt_abs, batch_abs)
    if _runs(mesh):
        return _sharded_train_step(cfg, global_batch, seq, tc, dev, mesh,
                                   rules or default_rules(mesh)), abstract
    m = tc.microbatches

    def value_and_grad(params, batch):
        # A leaf the loss does not read (olmo's norm gains: its LayerNorm
        # has none) gets a zero gradient, as under jax.value_and_grad.
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = model.loss_fn(tree_unflatten(params, leaves), batch, cfg)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def norm(grads):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))

    def train_step(params, opt_state, batch):
        with _rules_scope(mesh, rules):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}

            def part(i):
                if m == 1:
                    return batch
                return {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                        for k, v in batch.items()}
            loss, grads = _accumulate(lambda i: value_and_grad(params,
                                                               part(i)),
                                      m, dev)
            return _update(params, opt_state, loss, grads, m, norm, tc.adamw)

    return train_step, abstract


def _accumulate(value_and_grad, m: int, dev: torch.device):
    """(loss, grads) over m microbatches: ``value_and_grad(i)`` gives
    microbatch i's (loss, gradients).  With m > 1 the losses are summed and
    divided by m, the gradients cast to f32 and summed (not yet divided:
    across processes they are reduced first)."""
    if m == 1:
        return value_and_grad(0)
    acc, loss = None, torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(m):
        part_loss, g = value_and_grad(i)
        g = [x.float() for x in g]
        acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
        loss = loss + part_loss
    return loss / m, acc


def _update(params, opt_state, loss, grads, m: int, norm, adamw):
    """The step's tail: the summed gradients divided by m, their norm by
    ``norm``, and AdamW on ``params`` in place."""
    if m > 1:
        grads = [a / m for a in grads]
    with ranges.part("grad_norm"):
        grad_norm = norm(grads)
    with ranges.part("adamw"):
        params, opt_state = apply_updates(
            params, tree_unflatten(params, grads), opt_state, adamw)
    return params, opt_state, {"loss": loss, "grad_norm": grad_norm}


def _sharded_train_step(cfg: ModelConfig, global_batch: int, seq: int,
                        tc: TrainConfig, dev: torch.device, mesh: Mesh,
                        rules: Rules):
    """The train step on a mesh that runs its ``data`` and ``model`` axes,
    one process a device (``parallel.runtime``), with the numerics of the
    JAX step under ``jax.jit(in_shardings=..., out_shardings=...)``.

    ``params`` and ``opt_state``'s ``mu`` and ``nu`` are this process's
    blocks, laid out by ``step_specs(cfg, "train", ...)`` (each of shape
    ``shard_shape``); ``count`` is whole.  ``batch`` is the whole global
    batch; each process takes its rows, split over ``data`` (over ``pod``
    and ``data`` on a mesh with a ``pod`` axis; the processes of one such
    coordinate hold the same rows).  Where the global batch does not
    divide, ``spec_for`` replicates it, as JAX does, and every process
    computes the whole batch.

    * Microbatch i is rows [i·B/m, (i+1)·B/m) of the global batch, as in
      the JAX step, and this process takes its share of it: rows i·B/m +
      d·B/(m·n) onwards, B/(m·n) of them, at batch coordinate d of n.
      The MoE's capacity is that of the whole microbatch
      (``models/modules.py``, ``moe_ffn``).
    * The params go to the model as this process's blocks, and each
      layer gathers its own leaves whole over ``data`` when it runs (in
      its forward, and again in its recompute under remat), as do the
      embedding and the unembedding (``parallel.ctx.gather_params``);
      each stays this process's block over ``model``, and the layers
      compute on those blocks (``models/modules.py``).  No process holds
      more than one layer's gathered weights at once under remat "full"
      (under "none" the saved products keep them until the backward).
    * The loss of a microbatch is its global masked mean, Σ sum_r / Σ
      count_r over the batch's group (the vocabulary-parallel loss gives
      every ``model`` process the whole sums of its rows): each process
      backpropagates sum_r / Σ count_r, so the gradients summed over
      the batch's processes are the global gradient.
    * The gradient of a leaf split over ``data`` leaves the backward as
      this process's block, summed over ``data`` one layer at a time (a
      reduce-scatter, ``runtime.gather_data``); with microbatches the
      blocks add up over them.  Then ``reduce_tree`` all-reduces each
      block over ``pod`` and each leaf not split over ``data`` over the
      batch's group.  The sum is divided by m, and AdamW updates the
      blocks in place (``apply_updates``: elementwise).  A leaf split over
      ``model`` has its block's gradient; one that every ``model``
      process holds whole has the whole gradient, the same on each.  A
      leaf that the ``model`` processes each use on their own part
      (Mamba-2's ``w_in`` and ``conv_w``) has its gradient summed over
      ``model`` inside the layer (``runtime.gather_blocks``,
      ``runtime.to_model``: ``models/ssm.py``).
    * ``loss`` and ``grad_norm`` come out whole, equal on every process;
      ``grad_norm`` counts a leaf replicated over an axis once
      (``global_norm``).

    At one process each collective is a copy, and the step gives the
    bits of the one-process step.  ``tc.grad_compression`` is read by
    nothing, as in the JAX step (ROADMAP F16)."""
    grads, p_spec = _sharded_grads(cfg, global_batch, seq, tc, dev, mesh,
                                   rules)
    spec_leaves = tree_leaves(p_spec)

    def train_step(params, opt_state, batch):
        loss, g = grads(params, batch)
        return _update(params, opt_state, loss, tree_leaves(g),
                       tc.microbatches,
                       lambda g: runtime.global_norm(g, spec_leaves, mesh),
                       tc.adamw)

    return train_step


def _sharded_grads(cfg: ModelConfig, global_batch: int, seq: int,
                   tc: TrainConfig, dev: torch.device, mesh: Mesh,
                   rules: Rules):
    """(grads, p_spec): ``grads(params, batch)`` is ``_sharded_train_step``
    up to AdamW: (the loss, this process's blocks of the gradient summed
    over the batch's processes and over the microbatches, not yet divided
    by their count)."""
    runtime.check_executable(mesh)
    model = get_model(cfg)
    (p_spec, _, b_spec), _ = step_specs(cfg, "train", mesh, global_batch,
                                        seq, tc, rules)
    m = tc.microbatches
    axes, rows, first = _batch_rows(b_spec["positions"], mesh,
                                    global_batch, m)
    group = _batch_group(mesh, axes)

    def part(batch, i):
        at = i * (global_batch // m) + first
        return {k: torch.as_tensor(v[at:at + rows], device=dev)
                for k, v in batch.items()}

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        # the backward pass runs in the scope too: remat runs the forward
        # again there, and gathers the layer's weights again
        with activation_rules(mesh, rules, group, mesh.axis_group("model"),
                              params=p_spec):
            logits = model.forward(tree_unflatten(params, leaves), batch,
                                   cfg)
            with ranges.part("loss") as p:
                total, count = cross_entropy_terms(
                    p.input(logits), batch["targets"], vocab_split(cfg))
                if group is not None:
                    count = runtime.all_sum(count, group)
                loss = p.output(total / count.clamp(min=1.0))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if group is not None:
            with ranges.part("loss"):
                loss = runtime.all_sum(loss, group)
        return loss.detach(), grads

    def grads(params, batch):
        loss, g = _accumulate(
            lambda i: value_and_grad(params, part(batch, i)), m, dev)
        g = tree_unflatten(params, list(g))
        return loss, runtime.reduce_tree(g, p_spec, mesh, axes)

    return grads, p_spec


def _sharded_prefill_step(cfg: ModelConfig, global_batch: int, seq: int,
                          dev: torch.device, mesh: Mesh, rules: Rules):
    """The prefill step on a mesh that runs, as ``_sharded_train_step``
    lays it out: ``params`` are this process's blocks (``step_specs(cfg,
    "prefill", ...)``), each layer's gathered over ``data`` when it runs,
    and each process takes its rows of the whole ``batch``.  Returns this
    process's block of the last token's logits, as the JAX step's
    ``out_shardings`` lays them out: its rows over the batch's axes, its
    vocabulary columns over ``model``."""
    runtime.check_executable(mesh)
    model = get_model(cfg)
    (p_spec, b_spec), _ = step_specs(cfg, "prefill", mesh, global_batch,
                                     seq, rules=rules)
    axes, rows, first = _batch_rows(b_spec["positions"], mesh, global_batch)

    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v[first:first + rows], device=dev)
                 for k, v in batch.items()}
        with torch.no_grad(), activation_rules(
                mesh, rules, _batch_group(mesh, axes),
                mesh.axis_group("model"), params=p_spec):
            logits = model.forward(params, batch, cfg)
        return logits[:, -1, :]

    return prefill_step


def build_prefill_step(cfg: ModelConfig, global_batch: int, seq: int,
                       device="cuda", mesh: Optional[Mesh] = None,
                       rules: Optional[Rules] = None):
    """Returns (prefill_step, (params, batch) as meta tensors);
    ``prefill_step(params, batch)`` gives the last token's logits (B, V).
    On a mesh that runs, see ``_sharded_prefill_step``."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    batch_abs = make_batch_abstract(cfg, global_batch, seq)
    batch_abs.pop("targets")
    if _runs(mesh):
        return _sharded_prefill_step(cfg, global_batch, seq, dev, mesh,
                                     rules or default_rules(mesh)), \
            (params_abs, batch_abs)

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


def _cache_abstract(cfg: ModelConfig, global_batch: int, max_seq: int):
    model = get_model(cfg)
    if cfg.family == "ssm":
        return model.init_cache(cfg, global_batch, device=META)
    return model.init_cache(cfg, global_batch, max_seq, device=META)


def build_decode_step(cfg: ModelConfig, global_batch: int, max_seq: int,
                      device="cuda", mesh: Optional[Mesh] = None,
                      rules: Optional[Rules] = None):
    """One-token serve_step against a max_seq KV cache (or, for the SSM
    family, the O(1) conv and SSM state; ``max_seq`` is then not used).
    Returns (serve_step, (params, cache, lengths, tokens) as meta tensors);
    ``serve_step`` returns (logits (B, 1, V), cache), the cache updated in
    place.  On a mesh that runs, see ``_sharded_decode_step``."""
    dev = resolve_device(device)
    model = get_model(cfg)
    params_abs = _meta_params(model.specs(cfg), cfg.param_dtype)
    cache_abs = _cache_abstract(cfg, global_batch, max_seq)
    lengths_abs = torch.empty((global_batch,), dtype=torch.int32,
                              device=META)
    tokens_abs = torch.empty((global_batch, 1), dtype=torch.int32,
                             device=META)
    abstract = (params_abs, cache_abs, lengths_abs, tokens_abs)
    if _runs(mesh):
        return _sharded_decode_step(cfg, global_batch, max_seq, dev, mesh,
                                    rules or default_rules(mesh)), abstract

    def serve_step(params, cache, lengths, tokens):
        with torch.no_grad(), _rules_scope(mesh, rules):
            return model.decode_step(
                params, cache, torch.as_tensor(lengths, device=dev),
                torch.as_tensor(tokens, device=dev), cfg)

    return serve_step, abstract


def _seq_split(kv_spec, mesh: Mesh) -> SeqSplit:
    """How a KV cache laid out by ``kv_spec`` (its dimension 3 is
    ``cache_seq``) splits its sequence: over the axes its entry names
    (``_block_of``); no group where the sequence is whole."""
    axes = spec_axes(kv_spec[3] if len(kv_spec) > 3 else None)
    if not axes:
        return SeqSplit(None, 0, 1)
    return SeqSplit(runtime.axes_group(mesh, axes), *_block_of(mesh, axes))


def _sharded_decode_step(cfg: ModelConfig, global_batch: int, max_seq: int,
                         dev: torch.device, mesh: Mesh, rules: Rules):
    """The decode step on a mesh that runs, laid out by ``step_specs(cfg,
    "decode", ...)`` as the JAX step under ``jax.jit(in_shardings=...,
    out_shardings=...)``: ``params`` are this process's blocks, each
    layer's gathered over ``data`` in its turn at every token; ``cache`` is
    this process's block of the cache (``init_cache_blocks``), updated in
    place; ``lengths`` and ``tokens`` are whole, and each process takes
    its rows where the batch splits over ``data`` (or ``pod`` and
    ``data``).  Returns (this process's block of the logits: its rows over
    the batch's axes, its vocabulary columns over ``model``; ``cache``).

    The KV cache holds positions [s0, s1) of this process's rows for
    every kv head (``cache_seq`` over ``model`` under ``default_rules``;
    over ``data`` and ``model``, or ``pod``, ``data`` and ``model``, with
    the batch whole, under ``long_context_rules``), and each layer's
    attention merges the blocks over the group that splits them
    (``modules.decode_attention``).  The Mamba-2 positions hold the whole
    conv window and the SSM state of their heads (``models/ssm.py``)."""
    runtime.check_executable(mesh)
    model = get_model(cfg)
    (p_spec, c_spec, l_spec, _), _ = step_specs(cfg, "decode", mesh,
                                                global_batch, max_seq,
                                                rules=rules)
    axes, rows, first = _batch_rows(l_spec, mesh, global_batch)
    seq = _seq_split(c_spec.get("kv", P()) if isinstance(c_spec, dict)
                     else c_spec, mesh)

    def serve_step(params, cache, lengths, tokens):
        lengths = torch.as_tensor(lengths[first:first + rows], device=dev)
        tokens = torch.as_tensor(tokens[first:first + rows], device=dev)
        with torch.no_grad(), activation_rules(
                mesh, rules, _batch_group(mesh, axes),
                mesh.axis_group("model"), seq, params=p_spec):
            return model.decode_step(params, cache, lengths, tokens, cfg)

    return serve_step


def init_cache_blocks(cfg: ModelConfig, global_batch: int, max_seq: int,
                      mesh: Mesh, rules: Optional[Rules] = None,
                      device="cuda"):
    """This process's block of a zero decode cache on ``mesh``, at the
    ``shard_shape`` of its spec in ``step_specs(cfg, "decode", ...)``:
    no process holds the whole cache.  On a mesh that only plans, the
    whole cache."""
    dev = resolve_device(device)
    cache_abs = _cache_abstract(cfg, global_batch, max_seq)
    (_, c_spec, _, _), _ = step_specs(cfg, "decode", mesh, global_batch,
                                      max_seq, rules=rules)

    def block(x, spec):
        shape = (shard_shape(tuple(x.shape), spec, mesh) if _runs(mesh)
                 else tuple(x.shape))
        return torch.zeros(shape, dtype=x.dtype, device=dev)
    if isinstance(cache_abs, dict):
        return {k: block(v, c_spec[k]) for k, v in cache_abs.items()}
    return block(cache_abs, c_spec)


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
    cache_abs = _cache_abstract(cfg, global_batch, seq)
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
