"""Dry-run of every (arch × shape × mesh) cell: one device's own step, run
once on meta tensors in a process group of the mesh's size whose
collectives move nothing, and H100 roofline terms.

For each cell:
  * skip exactly as ``shapes.skip_reason`` says;
  * start a default process group of the mesh's size (256, or 512 with
    ``--multi-pod``) on torch's ``fake`` backend, this process its rank 0
    (``fake_group``: its collectives return at once and move nothing);
  * build the mesh with ``make_host_mesh(model=16, pod=1 or 2,
    device="meta")`` and the step through the sharded builders
    (``build_train_step``, ``build_prefill_step``, ``build_decode_step``
    on that mesh), as a run across processes builds them;
  * hand the step this device's inputs (params, AdamW moments and the
    decode cache as its blocks, at ``shard_shape``; the batch, lengths
    and tokens whole, as every process gets them) and run it once under a
    dispatch mode that counts every aten op of this device
    (``_MetaCounter``): flops as XLA's cost analysis counts them (the
    products from ``torch.utils.flop_counter``'s registry, every other op
    by ``_RULES``), transcendentals apart, bytes as each op's inputs plus
    outputs, the peak of the storages it allocates, and every collective
    it issues (a ``c10d`` op) by kind, with its calls and result bytes;
    the hand-written kernels' meta branches add their least work at the
    local shapes (``kernels/cost.py``);
  * take ``memory.argument_bytes`` from ``train.step.step_specs``: the sum
    of each input's per-device shard (``shard_shape``) bytes;
  * derive the three roofline terms from H100 SXM data-sheet constants;
  * write one JSON artifact per cell under ``--out`` (none with ``--out
    ""``).

Rank 0 stands for every rank: ``spec_for`` splits only dimensions that
divide, so every rank's blocks, and so its work and its collectives, have
the same shapes (``tests/test_torch_dryrun_plan.py`` holds rank 0's plan
against the last rank's, and each rank's against what a gloo process
issues in its real step).

Departures from the JAX package's dry-run (``src/repro/launch/dryrun.py``),
which lowers and compiles each cell with XLA on 512 host devices:

  * nothing is compiled or fused: bytes stay unfused, each aten op's
    inputs read and outputs written once (a view or an uninitialised
    allocation moves nothing; an in-place op's output is its input; a
    collective's bytes are its own term); ``compile_s`` holds the seconds
    of the cell's meta run; ``memory.temp_bytes`` is the peak of the
    storages the run allocates, alive at once (weakref finalizers on
    each), not XLA's buffer assignment;
  * there is no loop to correct: layers are walked by a Python loop and
    counted each, so the reference's two-point loop correction
    (``corrected_costs``) and its ``raw_loop_*`` fields are dropped;
  * the collectives are the port's runtime (``parallel/runtime.py``), not
    XLA's partitioner.  Where the two differ (decode gathers each layer's
    FSDP weights at every token where XLA moves activations; the MoE
    gathers the batch's tokens over the batch's group), that difference is
    the runtime's layout (ROADMAP item 16), not the count.

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
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import get_config
from ..kernels import cost as kcost
from ..parallel.sharding import (PartitionSpec, default_rules,
                                 long_context_rules, shard_shape, tree_map)
from ..train.optimizer import AdamWConfig, init_state
from ..train.step import (TrainConfig, build_decode_step, build_prefill_step,
                          build_train_step, init_cache_blocks, step_specs)
from .mesh import make_host_mesh, make_production_mesh
from .shapes import SHAPES, skip_reason

# H100 SXM data-sheet constants (per card)
PEAK_FLOPS = kcost.BF16_FLOPS        # bf16 dense
HBM_BW = kcost.HBM_BYTES_PER_S       # bytes/s
NVLINK_BW = 450e9                    # bytes/s a direction (NVLink 4)

META = torch.device("meta")
_aten = torch.ops.aten
# Ops that move no bytes: an uninitialised allocation, and reshapes whose
# schema does not mark them as views.
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
             _aten.lift_fresh}

# The kind of each collective the runtime issues, as the reference's
# ``collective_bytes`` names XLA's; any other c10d op counts under its own
# name.
_COLLECTIVES = {"_allgather_base_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "allreduce_": "all-reduce"}

# Flops as XLA's cost analysis counts them, for every aten op that is not
# a product (those are ``flop_registry``'s): (flops per output element,
# flops per element of the first input, transcendentals per output
# element).  Each rule is XLA's count for the jnp counterpart in the
# comment beside it, probed with ``jax.jit(f).lower(*xs).compile()
# .cost_analysis()`` on the CPU, on 1000 f32 elements unless it says
# otherwise; ``tests/test_torch_dryrun_flops.py`` holds every rule against
# its counterpart.  An op in no rule counts no flops: copies, views,
# concatenation, padding, fills and iota (XLA: 0 for pad, concatenate and
# iota), index gathers and scatters without a sum (XLA counts ~3 an index
# for its index arithmetic), sorts and searches (XLA: n·⌈log2 n⌉ for a
# sort; the MoE's routing sorts are small beside its products).
_RULES = {
    # pointwise arithmetic, comparison, selection: 1000
    # (x + y, x - y, 1 - x, x * y, x / y, -x, |x|, max(x, y), min(x, y),
    # 1 / x, x == y, ..., p & q, ~p, select(p, x, y), clip(x, 0, 1))
    **{op: (1, 0, 0) for op in (
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum",
        "minimum", "reciprocal", "eq", "ne", "lt", "le", "gt", "ge",
        "bitwise_and", "bitwise_or", "bitwise_not", "where", "masked_fill",
        "clamp")},
    "floor_divide": (8, 0, 0),            # x // 7 on int32: 8000
    "remainder": (6, 0, 0),               # x % 7 on int32: 6000
    # exp, log, rsqrt, sqrt, tanh, erf, sin, cos: 0 flops, 1000
    # transcendentals
    **{op: (0, 0, 1) for op in (
        "exp", "log", "rsqrt", "sqrt", "tanh", "erf", "sin", "cos")},
    "sigmoid": (3, 0, 1),                 # jax.nn.sigmoid: 3000 + 1000
    "silu": (4, 0, 1),                    # jax.nn.silu: 4000 + 1000
    "softplus": (6, 0, 2),                # jax.nn.softplus: 6000 + 2000
    # a backward op: the jnp expression of its own formula;
    # silu_backward(g, x): g·s·(1 + x·(1 − s)), s = sigmoid(x): 8000 + 1000
    "silu_backward": (8, 0, 1),
    # gelu_backward(g, x, "tanh"), torch's formula: 17000 + 1000
    "gelu_backward": (17, 0, 1),
    # softplus_backward(g, x): where(x > 20, g, g·z / (z + 1)), z = exp(x):
    # 5000 + 1000
    "softplus_backward": (5, 0, 1),
    # reductions: a sum of n terms is n − 1 adds, so one an input element
    # less one an output element (x.max(-1) of (16, 32768): 524272; x.sum(-1)
    # of (1000, 3): 2000; XLA pads short rows: (10, 100) gives 1270 for
    # our 990); a mean adds its division (x.mean(-1) of (64, 2048): 131072)
    **{op: (-1, 1, 0) for op in ("sum", "amax")},
    "mean": (0, 1, 0),
    # softmax(x) over rows: two reductions, x − max, exp and the division
    # (jax.nn.softmax of (1000, 3): 10000 + 3000; of (10, 100): 4540 +
    # 1000); its backward y·(g − Σ g·y), three pointwise and a reduction
    # ((1000, 3): 11000); each reduction less one an output row
    # (``xla_flops``)
    "_softmax": (4, 0, 1),
    "_softmax_backward_data": (4, 0, 0),
}


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _first_tensor(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (list, tuple)):
            for t in v:
                if isinstance(t, torch.Tensor):
                    return t
    return None


def xla_flops(func, args, kwargs, out):
    """(flops, transcendentals) of one aten op that is not a product, as
    XLA counts its counterpart (``_RULES``; an in-place op, ``add_``, as
    its functional one).  Besides the table: a cast (``_to_copy``, or
    ``copy_`` into another dtype) is one flop an element (f32 → bf16, bf16
    → f32, int32 → f32, bool → f32: 1000); ``pow`` is one where the
    exponent is 2 (x ** 2: 1000) and a transcendental otherwise (x ** 2.5,
    x ** y: 0 + 1000); ``gelu`` is jax.nn.gelu's tanh form (8000 + 1000)
    or its erf form, x·0.5·(1 + erf(x / √2)) (4000 + 1000);
    ``scatter_add`` (the loss's backward) one add an element of its
    source (x.at[i].add(u) of 1000 rows of 100: 103000, 3 of them index
    arithmetic an index)."""
    name = func._overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    result = out[0] if isinstance(out, (tuple, list)) else out
    n_out = _numel(result)
    if name == "_to_copy":
        return (n_out if kwargs.get("dtype", args[0].dtype)
                != args[0].dtype else 0), 0
    if name == "copy":
        return (n_out if args[1].dtype != args[0].dtype else 0), 0
    if name == "pow":
        return (n_out, 0) if isinstance(args[1], (int, float)) \
            and args[1] == 2 else (0, n_out)
    if name == "gelu":
        return (8 * n_out if kwargs.get("approximate") == "tanh"
                else 4 * n_out), n_out
    if name == "scatter_add":
        return _numel(args[3]), 0
    if name in ("_softmax", "_softmax_backward_data"):
        x, dim = (args[0], args[1]) if name == "_softmax" \
            else (args[0], args[2])
        rows = x.numel() // x.shape[dim] if x.dim() else 1
        reductions = 2 if name == "_softmax" else 1
        per_out, _, trans = _RULES[name]
        return per_out * n_out - reductions * rows, trans * n_out
    rule = _RULES.get(name)
    if rule is None:
        return 0, 0
    per_out, per_in, trans = rule
    return per_out * n_out + per_in * _numel(_first_tensor(args)), \
        trans * n_out


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _MetaCounter(TorchDispatchMode):
    """Counts each aten op of one device's step: flops and
    transcendentals as XLA counts them (``flop_registry``'s products,
    ``xla_flops`` for the rest), bytes as inputs plus outputs, the peak of
    the storages it allocates that are alive at once, and each collective
    (``c10d`` op) by kind: ``collectives[kind]`` is {"calls", "bytes"},
    the bytes of the tensors it writes (all-gather: the gathered tensor;
    reduce-scatter: the output block; all-reduce: the tensor), the
    result-shape bytes the reference's ``collective_bytes`` sums over the
    HLO.  Works on meta tensors and on real ones alike."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self._known = set()      # storages made before the run (inputs)
        self._mine = {}          # storages made by the run: key -> bytes

    def _release(self, key):
        self.live -= self._mine.pop(key)

    def _collective(self, func, args):
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name, name)
        written = _tensors(args[:1])
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += sum(_nbytes(t) for t in written)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        else:
            flops, trans = xla_flops(func, args, kwargs, out)
            self.flops += flops
            self.transcendentals += trans
        ins = _tensors((*args, *kwargs.values()))
        outs = [t for t in _tensors((out,)) if not any(t is i for i in ins)]
        if not (func.is_view or packet in _NO_BYTES):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
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


def _train_config(cfg) -> TrainConfig:
    # 314B-class models need bf16 moments to fit
    moment_dtype = (torch.bfloat16 if cfg.param_count() > 5e10
                    else torch.float32)
    return TrainConfig(adamw=AdamWConfig(moment_dtype=moment_dtype))


def _rules(name: str, mesh):
    return (long_context_rules if name == "long_context"
            else default_rules)(mesh)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A default process group of ``world`` processes, this one at
    ``rank``, on torch's ``fake`` backend: its collectives (on meta
    tensors, or any) return at once and move nothing, so one process runs
    one device's program of a mesh it does not have.  Refuses to start
    where a process group already exists (a count against a live group
    would move data), and leaves none behind."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts a process group of its own; "
                           "one is already initialised in this process")
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Plan:
    """One device's step, counted: ``counter`` (``_MetaCounter``),
    ``kernels`` (the kernels' ``kcost.Cost``), ``inputs`` (the step's
    whole inputs as meta tensors, as the builders return them) and
    ``in_specs`` (their placements, ``step_specs``), ``outputs`` (this
    device's), ``mesh_shape`` and ``seconds``."""
    counter: _MetaCounter
    kernels: kcost.Cost
    inputs: Any
    in_specs: Any
    outputs: Any
    mesh_shape: Dict[str, int]
    seconds: float


def _blocks(tree, specs, mesh):
    """A meta tensor of each leaf's block (``shard_shape``)."""
    return tree_map(lambda t, s: torch.empty(
        shard_shape(tuple(t.shape), s, mesh), dtype=t.dtype, device=META),
        tree, specs)


def plan(cfg, kind: str, global_batch: int, seq: int, *, model: int,
         pod: int = 1, world: int, rank: int = 0, rules: str = "default",
         tc: TrainConfig = None) -> Plan:
    """The step of ``kind`` ("train", "prefill" or "decode": ``seq`` is
    then the cache's ``max_seq``) of process ``rank`` of ``world``, on
    ``make_host_mesh(model, pod, "meta")`` in a fake group
    (``fake_group``) under ``rules`` ("default" or "long_context"), run
    once on meta tensors and counted.  The step is the one the sharded
    builders give a run across processes; it gets this device's blocks
    of the params, AdamW moments and decode cache, and the whole batch."""
    tc = tc or TrainConfig()
    t0 = time.time()
    with fake_group(world, rank):
        mesh = make_host_mesh(model=model, pod=pod, device="meta")
        r = _rules(rules, mesh)
        kw = dict(device="meta", mesh=mesh, rules=r)
        in_specs, _ = step_specs(cfg, kind, mesh, global_batch, seq, tc, r)
        if kind == "train":
            fn, inputs = build_train_step(cfg, global_batch, seq, tc, **kw)
            params = _blocks(inputs[0], in_specs[0], mesh)
            local = (params, init_state(params, tc.adamw), inputs[2])
        elif kind == "prefill":
            fn, inputs = build_prefill_step(cfg, global_batch, seq, **kw)
            local = (_blocks(inputs[0], in_specs[0], mesh), inputs[1])
        else:
            fn, inputs = build_decode_step(cfg, global_batch, seq, **kw)
            local = (_blocks(inputs[0], in_specs[0], mesh),
                     init_cache_blocks(cfg, global_batch, seq, mesh, r,
                                       device="meta"), *inputs[2:])
        kernels = kcost.Cost()
        counter = _MetaCounter()
        with kcost.counting(kernels), counter:
            outputs = fn(*local)
        shape = mesh.shape
    return Plan(counter, kernels, inputs, in_specs, outputs, shape,
                time.time() - t0)


def _tree_shard_bytes(abstract, specs, mesh) -> int:
    """Σ per-device shard bytes over a tree of meta tensors and the spec
    tree that places it."""
    sizes = []
    tree_map(lambda t, s: sizes.append(math.prod(shard_shape(
        tuple(t.shape), s, mesh)) * t.dtype.itemsize), abstract, specs)
    return sum(sizes)


def _as_tree(x):
    """Tuples of trees as dicts, so ``tree_map`` walks them (a tuple is a
    leaf there: a spec is one)."""
    if isinstance(x, tuple) and not isinstance(x, PartitionSpec):
        return {i: _as_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    return x


def _local_bytes(tree) -> int:
    """The bytes of this device's outputs (a tree of tensors)."""
    return sum(_nbytes(t) for t in _tensors(_flat(tree)))


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str) -> dict:
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape)
    if reason is not None:
        return {"arch": arch, "shape": shape, "skipped": reason}
    spec = SHAPES[shape]
    pod = 2 if multi_pod else 1
    n_dev = pod * 16 * 16
    rules_name = "long_context" if shape == "long_500k" else "default"
    tc = _train_config(cfg)
    p = plan(cfg, spec.kind, spec.global_batch, spec.seq, model=16, pod=pod,
             world=n_dev, rules=rules_name, tc=tc)
    counter, kernels = p.counter, p.kernels
    arg_bytes = _tree_shard_bytes(_as_tree(p.inputs), _as_tree(p.in_specs),
                                  make_production_mesh(multi_pod=multi_pod))
    out_bytes = _local_bytes(p.outputs)
    temp_bytes = counter.peak
    coll = {k: v["bytes"] for k, v in sorted(counter.collectives.items())}
    calls = {k: v["calls"] for k, v in sorted(counter.collectives.items())}

    flops = counter.flops + kernels.flops
    hbm_bytes = counter.bytes + kernels.bytes
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
        "compile_s": round(p.seconds, 3),
        "params": n_param, "active_params": n_active,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "peak_bytes": arg_bytes + temp_bytes,
        },
        "cost": {"flops_per_dev": flops,
                 "transcendentals_per_dev": counter.transcendentals,
                 "hbm_bytes_per_dev": hbm_bytes,
                 "kernel_calls": kernels.calls},
        "collectives": coll,
        "collective_calls": calls,
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
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            try:
                r = run_cell(a, s, mp, args.out)
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
