"""Dry-run of every (arch × shape × mesh) cell: the step run once on meta
tensors, its placements on the production mesh, and H100 roofline terms.

For each cell:
  * skip exactly as ``shapes.skip_reason`` says;
  * take the step's placements on the mesh descriptor (16×16 or 2×16×16)
    from ``train.step.step_specs``: ``memory.argument_bytes`` and
    ``memory.output_bytes`` are the sums of each input's and output's
    per-device shard (``shard_shape``) bytes;
  * run the step (train, prefill or serve) once at the global shapes on
    meta tensors, under ``activation_rules`` on the mesh and a dispatch
    mode that counts every aten op: flops with
    ``torch.utils.flop_counter``'s registry (the products), bytes as each
    op's inputs plus outputs, and the peak of live storages; the
    hand-written kernels' meta branches add their least work
    (``kernels/cost.py``);
  * derive collective bytes from the placements (``collective_bytes``);
  * derive the three roofline terms from H100 SXM data-sheet constants;
  * write one JSON artifact per cell under ``--out`` (none with ``--out
    ""``).

Departures from the JAX package's dry-run (``src/repro/launch/dryrun.py``),
which lowers and compiles each cell with XLA on 512 host devices:

  * nothing is lowered or compiled: ``compile_s`` holds the seconds of the
    cell's meta run, which serves both meshes; the reference's
    ``raw_loop_*`` fields are not written (there is no loop to correct);
  * the counts are of the whole step at the global shapes, on one device,
    divided by the device count; XLA counts the partitioned program of one
    device, which also repeats the work that stays replicated;
  * flops are the products' (and the kernels' formulas); XLA also counts
    elementwise work;
  * bytes are unfused: each aten op's inputs read and outputs written once
    (a view or an uninitialised allocation moves nothing; an in-place
    op's output is its input); XLA counts its fused, partitioned program
    (``tools/dryrun_compare.py`` prints the two side by side);
  * ``memory.temp_bytes`` is the peak of the storages the run allocates,
    alive at once (weakref finalizers on each), not XLA's buffer
    assignment;
  * layers are walked by a Python loop, counted each, so the reference's
    two-point loop correction (``corrected_costs``, its lines 124-155) is
    dropped;
  * collectives are counted from the placements, not parsed from HLO
    (``collective_bytes`` lists the terms): the plan that gathers every
    FSDP-split weight, where XLA's partitioner may move activations
    instead (at olmo-1b decode_32k its HLO all-gathers 8x fewer bytes).

The constants are the H100 SXM data sheet's: bf16 dense 989e12 FLOP/s
and HBM 3.35e12 B/s (``kernels.cost``), NVLink 450e9 B/s a direction.  A
16-wide model axis spans two 8-GPU NVLink nodes, whose link between them
is slower than NVLink, so the collective term is a lower bound for its
bytes.  These are computed terms, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] \\
      [--out artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import get_config
from ..kernels import cost as kcost
from ..models import get_model
from ..parallel.sharding import (Mesh, PartitionSpec, default_rules,
                                 long_context_rules, shard_shape, spec_axes,
                                 spec_for, tree_map)
from ..train.optimizer import AdamWConfig
from ..train.step import (TrainConfig, build_decode_step, build_prefill_step,
                          build_train_step, step_specs)
from .mesh import make_production_mesh
from .shapes import SHAPES, skip_reason

# H100 SXM data-sheet constants (per card)
PEAK_FLOPS = kcost.BF16_FLOPS        # bf16 dense
HBM_BW = kcost.HBM_BYTES_PER_S       # bytes/s
NVLINK_BW = 450e9                    # bytes/s a direction (NVLink 4)

_aten = torch.ops.aten
# Ops that move no bytes: an uninitialised allocation, and reshapes whose
# schema does not mark them as views.
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
             _aten.lift_fresh}


def _tensors(values) -> list:
    """The tensors among an op's arguments or results (an argument may be
    a list of tensors)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


class _MetaCounter(TorchDispatchMode):
    """Counts each aten op of a meta run: flops from the flop registry,
    bytes as inputs plus outputs, and the peak of the storages it
    allocates that are alive at once."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = set()      # storages made before the run (inputs)
        self._mine = {}          # storages made by the run: key -> bytes

    def _release(self, key):
        self.live -= self._mine.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        ins = _tensors((*args, *kwargs.values()))
        outs = [t for t in _tensors((out,)) if not any(t is i for i in ins)]
        if not (func.is_view or packet in _NO_BYTES):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in ins:
            key = t.untyped_storage()._cdata
            if key not in self._mine:
                self._known.add(key)
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._mine or key in self._known:
                continue
            self._mine[key] = storage.nbytes()
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, key)
        return out


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _tree_shard_bytes(abstract, specs, mesh) -> int:
    """Σ per-device shard bytes over a tree of meta tensors and the spec
    tree that places it."""
    sizes = []
    tree_map(lambda t, s: sizes.append(_nbytes(
        shard_shape(tuple(t.shape), s, mesh), t.dtype)), abstract, specs)
    return sum(sizes)


def _as_tree(x):
    """Tuples of trees as dicts, so ``tree_map`` walks them (a tuple is a
    leaf there: a spec is one)."""
    if isinstance(x, tuple) and not isinstance(x, PartitionSpec):
        return {i: _as_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    return x


def _train_config(cfg) -> TrainConfig:
    # 314B-class models need bf16 moments to fit
    moment_dtype = (torch.bfloat16 if cfg.param_count() > 5e10
                    else torch.float32)
    return TrainConfig(adamw=AdamWConfig(moment_dtype=moment_dtype))


def meta_run(cfg, shape: str, mesh: Mesh, rules, tc: TrainConfig):
    """The step of ``shape`` run once on meta tensors at its global
    shapes.  Returns (counter, kernel cost, abstract inputs, outputs)."""
    spec = SHAPES[shape]
    kw = dict(device="meta", mesh=mesh, rules=rules)
    if spec.kind == "train":
        fn, inputs = build_train_step(cfg, spec.global_batch, spec.seq, tc,
                                      **kw)
    elif spec.kind == "prefill":
        fn, inputs = build_prefill_step(cfg, spec.global_batch, spec.seq,
                                        **kw)
    else:
        fn, inputs = build_decode_step(cfg, spec.global_batch, spec.seq,
                                       **kw)
    kernels = kcost.Cost()
    counter = _MetaCounter()
    with kcost.counting(kernels), counter:
        outputs = fn(*inputs)
    return counter, kernels, inputs, outputs


def collective_bytes(cfg, kind: str, mesh: Mesh, rules, params_abs,
                     p_spec, axes, global_batch: int, seq: int) -> dict:
    """Result-shape bytes a device receives from each kind of collective in
    one step, derived from the placements (``p_spec``, with the params'
    logical ``axes``); the reference's ``collective_bytes`` sums the same
    quantity over the HLO.  With ``passes`` 2 for train (forward and
    backward) and 1 otherwise:

      * all-gather (FSDP): each parameter leaf sharded over ``data``/``pod``
        gathered over those axes, ``passes`` times: its shard's bytes times
        their size, in the param dtype;
      * reduce-scatter (FSDP, train): each such leaf's f32 gradient, its
        shard's bytes;
      * all-reduce (tensor parallelism): the local (B, S, d_model)
        activation in the compute dtype after each contraction back from a
        ``model``-sharded axis (attention's ``wo``, the FFN's down ``wo``,
        Mamba's ``w_out``, the MoE's combine), ``passes`` times a layer;
        and for train, two (B, S) f32 all-reduces of a vocab-sharded
        log-sum-exp;
      * all-to-all (expert parallelism, where the experts split over the
        mesh): the shard of the (E, cap, d_model) dispatch buffer in the
        compute dtype, each way (dispatch and combine), ``passes`` times a
        MoE layer; cap is the MoE's capacity for the step's global tokens.

    Not counted: decode attention over a sequence-sharded cache, and the
    batch's own movement."""
    passes = 2 if kind == "train" else 1
    tokens = 1 if kind == "decode" else seq
    act = (global_batch, tokens, cfg.d_model)
    act_shard = shard_shape(act, spec_for(act, ("act_batch", None, None),
                                          rules, mesh), mesh)
    act_bytes = _nbytes(act_shard, cfg.compute_dtype)
    out = {}

    def add(name, n):
        if n:
            out[name] = out.get(name, 0) + int(n)

    def layers(leaf, leaf_axes):
        return math.prod(n for n, a in zip(leaf.shape, leaf_axes)
                         if a == "layers")

    def walk(node, spec, node_axes):
        if isinstance(node, dict):
            if "router" in node:         # a (stack of) MoE FFN(s)
                n = global_batch * tokens
                cap = max(int(math.ceil(n * cfg.top_k / cfg.n_experts
                                        * cfg.capacity_factor)), 8)
                buf = (cfg.n_experts, cap, cfg.d_model)
                buf_spec = spec_for(buf, ("expert", None, None), rules, mesh)
                if buf_spec:             # experts split: tokens move
                    add("all-to-all", passes * 2 * layers(
                        node["wo"], node_axes["wo"]) * _nbytes(
                            shard_shape(buf, buf_spec, mesh),
                            cfg.compute_dtype))
            for k in node:
                walk(node[k], spec[k], node_axes[k])
            if "wo" in node or "w_out" in node:
                w = "wo" if "wo" in node else "w_out"
                # every axis but the layers' and the last (embed) is
                # contracted away
                contracted = [e for e, a in zip(spec[w], node_axes[w][:-1])
                              if a != "layers"]
                if any("model" in spec_axes(e) for e in contracted):
                    add("all-reduce", passes * layers(node[w], node_axes[w])
                        * act_bytes)
            return
        shard = shard_shape(tuple(node.shape), spec, mesh)
        fsdp = math.prod(mesh.shape[a] for e in spec for a in spec_axes(e)
                         if a in ("pod", "data"))
        if fsdp > 1:
            add("all-gather", passes * fsdp * _nbytes(shard, node.dtype))
            if kind == "train":
                add("reduce-scatter", _nbytes(shard, torch.float32))

    walk(params_abs, p_spec, axes)
    vocab = p_spec["unembed"]
    if kind == "train" and len(vocab) > 1 and "model" in spec_axes(vocab[1]):
        add("all-reduce", 2 * act_shard[0] * act_shard[1] * 4)
    return out


def _meta_run_cached(cache, cfg, shape, mesh, rules, tc):
    """``meta_run`` once per (config, shape), with its seconds: nothing in
    it depends on the mesh but the ``constrain`` checks, which hold on
    both meshes."""
    key = (repr(cfg), shape, repr(tc))
    if cache is None or key not in cache:
        t0 = time.time()
        result = meta_run(cfg, shape, mesh, rules, tc)
        result = (*result, time.time() - t0)
        if cache is None:
            return result
        cache[key] = result
    return cache[key]


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             _runs: dict = None) -> dict:
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape)
    if reason is not None:
        return {"arch": arch, "shape": shape, "skipped": reason}
    spec = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.devices.size

    if shape == "long_500k":
        rules_name, rules = "long_context", long_context_rules(mesh)
    else:
        rules_name, rules = "default", default_rules(mesh)
    tc = _train_config(cfg)
    counter, kernels, inputs, outputs, compile_s = _meta_run_cached(
        _runs, cfg, shape, mesh, rules, tc)
    in_specs, out_specs = step_specs(cfg, spec.kind, mesh, spec.global_batch,
                                     spec.seq, tc, rules)
    arg_bytes = _tree_shard_bytes(_as_tree(inputs), _as_tree(in_specs), mesh)
    out_bytes = _tree_shard_bytes(_as_tree(outputs), _as_tree(out_specs),
                                  mesh)
    temp_bytes = counter.peak / n_dev
    model = get_model(cfg)
    coll = collective_bytes(cfg, spec.kind, mesh, rules, inputs[0],
                            in_specs[0], model.logical_axes(cfg),
                            spec.global_batch, spec.seq)

    flops = (counter.flops + kernels.flops) / n_dev
    hbm_bytes = (counter.bytes + kernels.bytes) / n_dev
    coll_total = sum(coll.values())
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = coll_total / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    # decode processes 1 new token per sequence; train/prefill the full seq
    tokens = spec.global_batch * (1 if spec.kind == "decode" else spec.seq)
    n_param = cfg.param_count()
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        model_flops = 6 * n_active * tokens
    else:
        model_flops = 2 * n_active * tokens
    model_flops_per_dev = model_flops / n_dev
    useful = model_flops_per_dev / flops if flops else 0.0

    result = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "rules": rules_name,
        "devices": n_dev,
        "kind": spec.kind,
        "compile_s": round(compile_s, 3),
        "params": n_param, "active_params": n_active,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "peak_bytes": arg_bytes + temp_bytes,
        },
        "cost": {"flops_per_dev": flops, "hbm_bytes_per_dev": hbm_bytes,
                 "kernel_calls": kernels.calls},
        "collectives": coll,
        "collective_bytes_per_dev": coll_total,
        "roofline": {**terms, "dominant": dominant,
                     "model_flops_per_dev": model_flops_per_dev,
                     "useful_flops_ratio": useful,
                     "step_time_bound_s": max(terms.values()),
                     "mfu_bound": (model_flops_per_dev / PEAK_FLOPS)
                     / max(max(terms.values()), 1e-12)},
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape}_{result['mesh']}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    from ..configs import ARCHS
    from .shapes import cells

    archs = args.arch or (list(ARCHS) if args.all else ["olmo-1b"])
    shapes = args.shape or list(SHAPES)
    runnable, skipped = cells(archs, shapes)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for a, s, reason in skipped:
        print(f"SKIP {a} {s}: {reason}", flush=True)
    failures = 0
    for a, s in runnable:
        runs = {}          # the meta run, shared by the cell's meshes
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            try:
                r = run_cell(a, s, mp, args.out, _runs=runs)
                ro = r["roofline"]
                print(f"OK {a} {s} {mesh_name} compile={r['compile_s']}s "
                      f"dom={ro['dominant']} "
                      f"t=({ro['compute_s']:.3e},{ro['memory_s']:.3e},"
                      f"{ro['collective_s']:.3e}) "
                      f"useful={ro['useful_flops_ratio']:.2f} "
                      f"mfu_bound={ro['mfu_bound']:.2f}", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {a} {s} {mesh_name}: {type(e).__name__}: {e}",
                      flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
