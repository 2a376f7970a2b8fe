"""One process of a CPU process group, for the tests of the port's execution
across processes (``tests/test_torch_dist*.py``).

  python tests/torch_dist_worker.py RANK WORLD STORE JOB.json

``run_ranks`` starts WORLD of them and reads what they wrote.  Each joins
a gloo group of WORLD processes through a ``FileStore`` at STORE (its
collectives time out after the job's ``timeout`` seconds, 90 where it
names none), runs the job the JSON file describes and writes
``<out>/rank<RANK>.npz``.
Imports torch, numpy and ``repro_torch`` only.  Jobs:

* ``train``: the port's ``build_train_step`` on ``make_host_mesh`` for
  ``steps`` steps, from whole params given as an ``.npz`` of ``/``-joined
  leaf names (each process keeps its blocks: ``params_from_numpy_sharded``)
  or from the port's seeded init, on the batches of an ``.npz``
  (``<step>/<key>``); writes each step's loss and grad norm, ``count``, the
  mesh's shape, the shapes of this process's params, ``mu`` and ``nu``
  blocks, gathered whole, the params after the last step and, for an MoE,
  the experts each token kept at every routing (``recording_routes``).
* ``prefill``: the port's ``build_prefill_step`` on the same params,
  on step 0's batch; writes this process's block of the logits.
* ``grads``: the sharded train step's gradients up to AdamW
  (``step._sharded_grads``) on step 0's batch, gathered whole.
* ``decode``: the port's ``build_decode_step`` under ``rules``
  ("default" or "long_context") for ``steps`` tokens from the whole
  cache, lengths and tokens of an ``.npz`` (``cache/<key>``,
  ``lengths<t>``, ``tokens<t>``), each process holding its block of the
  cache; writes its block of each step's logits and of the cache after
  the last.
* ``norm``: ``global_norm`` of a tree with a split and a replicated leaf.
* ``norm2d``: ``global_norm`` on a (2, 2) mesh of leaves split over
  ``data``, over ``model``, over both, and over neither.
* ``model_axis``: builds the train, prefill and decode steps of each of
  ``archs`` on a mesh with ``model`` = 2, runs each once from the seeded
  init (decode from a zero cache of this process's blocks), and records
  what each raises and whether its results are finite.
* ``gathers``: the train step (remat "full" and "none"), the prefill and
  one decode token from the seeded init, each with ``runtime.gathered``
  zeroed before it: writes the gathers' count, bytes, the most bytes
  alive at once and the bytes still alive after it.
* ``collectives``: each of ``steps`` ("train", "prefill", "decode") of
  ``arch`` once from the seeded init (the train and prefill steps on
  step 0's synthetic batch of ``batch`` × ``seq``, decode one token from
  a zero cache of ``decode_batch`` × ``max_seq`` blocks), each under the
  dry-run's counter (``launch.dryrun._MetaCounter``): writes the calls
  and bytes of each kind of collective the step issued.
* ``ckpt_save``: one step from the seeded init, then ``save_sharded`` at
  step 1; writes the whole state gathered.
* ``ckpt_restore``: ``restore_sharded`` into zero blocks; writes the whole
  state gathered.
* ``seq``: the jobs of ``jobs`` one after another in the same group, the
  results of each under ``<its name>/``.

A job runs on ``make_host_mesh(model=job["model"], pod=job["pod"])``
(``model`` and ``pod`` 1 where it names none), one mesh of each shape for
the processes' lifetime.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (CheckpointConfig, CheckpointStore,
                                    named_leaves, restore_sharded,
                                    save_sharded)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, modules
from repro_torch.parallel import runtime
from repro_torch.parallel.sharding import (PartitionSpec as P, default_rules,
                                           long_context_rules)
from repro_torch.train import (AdamWConfig, TrainConfig, build_decode_step,
                               build_prefill_step, build_train_step,
                               init_cache_blocks, init_state, synthetic_batch)
from repro_torch.train.step import _sharded_grads, step_specs
from repro_torch.weights import params_from_numpy_sharded

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SRC = Path(__file__).resolve().parents[1] / "src"


def run_ranks(world: int, job: dict, tmp: Path, timeout: float = 240):
    """Run ``job`` in a gloo group of ``world`` worker processes on a
    FileStore in ``tmp``; returns each rank's results, in rank order.  The
    workers are killed if they outlive ``timeout`` seconds."""
    tmp.mkdir(parents=True, exist_ok=True)
    job = dict(job, out=str(tmp))
    (tmp / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / "store"),
         str(tmp / "job.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, errs
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def unflatten(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@contextlib.contextmanager
def recording_routes(calls):
    """Appends to ``calls``, at every MoE routing, an (N, E) bool array:
    the experts that each token's kept pairs went to."""
    route = modules.moe_route

    def record(logits, cfg):
        plan = route(logits, cfg)
        kept = torch.zeros((plan["idx"].shape[0], cfg.n_experts),
                           dtype=torch.bool)
        kept[plan["tok"], plan["idx"].reshape(-1)[plan["order"]]] = \
            plan["keep"]
        calls.append(kept.numpy())
        return plan
    with mock.patch.object(modules, "moe_route", record):
        yield


def config(job):
    kw = dict(job.get("overrides", {}))
    if "compute_dtype" in kw:
        kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
    return dataclasses.replace(get_config(job["arch"], smoke=True), **kw)


def state(job, cfg, mesh, tc):
    (p_spec, opt_spec, _), _ = step_specs(cfg, "train", mesh, job["batch"],
                                          job["seq"], tc)
    if job.get("init"):
        params = params_from_numpy_sharded(
            unflatten(dict(np.load(job["init"]))), p_spec, mesh, "cpu")
    else:
        full = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        params = runtime.shard_tree(full, p_spec, mesh)
    return params, init_state(params, tc.adamw), {"params": p_spec,
                                                  "opt": opt_spec}


def whole(tree, specs, mesh, prefix):
    return {f"{prefix}/{name}": x.numpy() for name, x in named_leaves(
        runtime.gather_whole_tree(tree, specs, mesh))}


def train(job, mesh, out):
    cfg = config(job)
    tc = TrainConfig(microbatches=job.get("microbatches", 1),
                     adamw=AdamWConfig(lr=job.get("lr", 1e-3)))
    step, _ = build_train_step(cfg, job["batch"], job["seq"], tc, "cpu",
                               mesh=mesh)
    params, opt, specs = state(job, cfg, mesh, tc)
    batches = np.load(job["batches"])
    routes = []
    with recording_routes(routes):
        for i in range(job["steps"]):
            batch = {k.split("/", 1)[1]: batches[k] for k in batches.files
                     if k.startswith(f"{i}/")}
            params, opt, metrics = step(params, opt, batch)
            for k, v in metrics.items():
                out[f"{k}{i}"] = float(v)
    if routes:
        out["routes"] = np.stack(routes)
    out["count"] = int(opt["count"])
    out["mesh"] = np.asarray(mesh.axis_sizes)
    for kind, tree in (("params", params), ("mu", opt["mu"]),
                       ("nu", opt["nu"])):
        for name, x in named_leaves(tree):
            out[f"shape/{kind}/{name}"] = np.asarray(x.shape)
    out.update(whole(params, specs["params"], mesh, "p"))


def prefill(job, mesh, out):
    cfg = config(job)
    step, _ = build_prefill_step(cfg, job["batch"], job["seq"], "cpu",
                                 mesh=mesh)
    params = state(job, cfg, mesh, TrainConfig())[0]
    batches = np.load(job["batches"])
    batch = {k.split("/", 1)[1]: batches[k] for k in batches.files
             if k.startswith("0/") and not k.endswith("/targets")}
    out["logits"] = step(params, batch).numpy()


def rules_of(job, mesh):
    return (long_context_rules if job.get("rules") == "long_context"
            else default_rules)(mesh)


def grads(job, mesh, out):
    cfg = config(job)
    tc = TrainConfig()
    fn, p_spec = _sharded_grads(cfg, job["batch"], job["seq"], tc,
                                torch.device("cpu"), mesh, rules_of(job, mesh))
    params = state(job, cfg, mesh, tc)[0]
    batches = np.load(job["batches"])
    batch = {k.split("/", 1)[1]: batches[k] for k in batches.files
             if k.startswith("0/")}
    loss, g = fn(params, batch)
    out["loss"] = float(loss)
    out.update(whole(g, p_spec, mesh, "g"))


def decode(job, mesh, out):
    cfg = config(job)
    rules = rules_of(job, mesh)
    b, s = job["batch"], job["max_seq"]
    step, (_, cache_abs, _, _) = build_decode_step(cfg, b, s, "cpu",
                                                   mesh=mesh, rules=rules)
    (p_spec, c_spec, _, _), _ = step_specs(cfg, "decode", mesh, b, s,
                                           rules=rules)
    params = params_from_numpy_sharded(
        unflatten(dict(np.load(job["init"]))), p_spec, mesh, "cpu")
    data = np.load(job["data"])
    at = runtime.coords(mesh)

    def block(x, spec, like):
        return torch.tensor(np.ascontiguousarray(
            x[runtime.local_slice(x.shape, spec, mesh, at)])).to(like.dtype)
    if isinstance(c_spec, dict):
        cache = {k: block(data[f"cache/{k}"], c_spec[k], cache_abs[k])
                 for k in c_spec}
    else:
        cache = block(data["cache/kv"], c_spec, cache_abs)
    for t in range(job["steps"]):
        logits, cache = step(params, cache, data[f"lengths{t}"],
                             data[f"tokens{t}"])
        out[f"logits{t}"] = logits.float().numpy()
    for k, v in (cache.items() if isinstance(cache, dict)
                 else [("kv", cache)]):
        out[f"cache/{k}"] = v.float().numpy()


def norm2d(job, mesh, out):
    """Leaves 0..n-1 of shape (4, 4), each a block by its spec: whole
    arange(16) + 16·i, split over data, over model, over both, over
    neither."""
    specs = [P("data"), P(None, "model"), P("data", "model"), P()]
    at = runtime.coords(mesh)
    leaves = []
    for i, spec in enumerate(specs):
        whole = (torch.arange(16.0) + 16 * i).reshape(4, 4)
        leaves.append(whole[runtime.local_slice((4, 4), spec, mesh, at)])
    out["norm"] = float(runtime.global_norm(leaves, specs, mesh))


def norm(job, mesh, out):
    rank = dist.get_rank()
    n = dist.get_world_size()
    split = torch.arange(4.0 * n)[rank * 4:(rank + 1) * 4]
    rep = torch.tensor([3.0, 4.0])
    out["norm"] = float(runtime.global_norm([split, rep],
                                            [P("data"), P()], mesh))


def model_axis(job, mesh, out):
    out["mesh"] = np.asarray(mesh.axis_sizes)
    b, s = job["batch"], job["seq"]
    for arch in job["archs"]:
        cfg = get_config(arch, smoke=True)
        tc = TrainConfig()
        batch = synthetic_batch(cfg, 0, b, s)
        inputs = {k: v for k, v in batch.items() if k != "targets"}
        (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, s, tc)
        full = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                   "cpu")

        def params():
            return runtime.shard_tree(full, p_spec, mesh)

        def train():
            step, _ = build_train_step(cfg, b, s, tc, "cpu", mesh=mesh)
            p = params()
            return step(p, init_state(p, tc.adamw), batch)[2]["loss"]

        def prefill():
            step, _ = build_prefill_step(cfg, b, s, "cpu", mesh=mesh)
            return step(params(), inputs)

        def decode():
            step, _ = build_decode_step(cfg, b, s, "cpu", mesh=mesh)
            cache = init_cache_blocks(cfg, b, s, mesh, device="cpu")
            return step(params(), cache, np.full(b, 3, np.int32),
                        batch.get("tokens", np.zeros((b, s), np.int32))
                        [:, :1])[0]
        for kind, run in (("train", train), ("prefill", prefill),
                          ("decode", decode)):
            try:
                res = run()
                out[f"raised/{arch}/{kind}"] = ""
                out[f"finite/{arch}/{kind}"] = bool(
                    torch.isfinite(res).all())
            except (NotImplementedError, ValueError) as e:
                out[f"raised/{arch}/{kind}"] = f"{type(e).__name__}: {e}"


def gathers(job, mesh, out):
    cfg = config(job)
    b, s = job["batch"], job["seq"]
    batch = synthetic_batch(cfg, 0, b, s)
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    tc = TrainConfig()
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, s, tc)
    full = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")

    def train(remat):
        c = dataclasses.replace(cfg, remat=remat)
        step, _ = build_train_step(c, b, s, tc, "cpu", mesh=mesh)
        params = runtime.shard_tree(full, p_spec, mesh)
        return lambda: step(params, init_state(params, tc.adamw), batch)

    def prefill():
        step, _ = build_prefill_step(cfg, b, s, "cpu", mesh=mesh)
        params = runtime.shard_tree(full, p_spec, mesh)
        return lambda: step(params, inputs)

    def decode():
        step, _ = build_decode_step(cfg, b, s, "cpu", mesh=mesh)
        params = runtime.shard_tree(full, p_spec, mesh)
        cache = init_cache_blocks(cfg, b, s, mesh, device="cpu")
        return lambda: step(params, cache, np.full(b, 3, np.int32),
                            batch["tokens"][:, :1])
    for kind, make in (("train_full", lambda: train("full")),
                       ("train_none", lambda: train("none")),
                       ("prefill", prefill), ("decode", decode)):
        run = make()
        runtime.reset_counts()
        run()
        for k in ("calls", "bytes", "peak"):
            out[f"{kind}/{k}"] = runtime.gathered[k]
        # gloo's worker thread may hold the last collective's output for a
        # moment after the call returns: wait up to 2 s for its release
        dist.barrier()
        deadline = time.monotonic() + 2
        while runtime.gathered["live"] and time.monotonic() < deadline:
            time.sleep(0.01)
        out[f"{kind}/live"] = runtime.gathered["live"]


def collectives(job, mesh, out):
    cfg = config(job)
    b, s = job["batch"], job["seq"]
    db, max_seq = job["decode_batch"], job["max_seq"]
    tc = TrainConfig()
    batch = synthetic_batch(cfg, 0, b, s)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, b, s, tc)
    full = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    for kind in job["steps"]:
        params = runtime.shard_tree(full, p_spec, mesh)
        if kind == "train":
            step, _ = build_train_step(cfg, b, s, tc, "cpu", mesh=mesh)
            args = (params, init_state(params, tc.adamw), batch)
        elif kind == "prefill":
            step, _ = build_prefill_step(cfg, b, s, "cpu", mesh=mesh)
            args = (params, {k: v for k, v in batch.items()
                             if k != "targets"})
        else:
            step, _ = build_decode_step(cfg, db, max_seq, "cpu", mesh=mesh)
            args = (params, init_cache_blocks(cfg, db, max_seq, mesh,
                                              device="cpu"),
                    np.full(db, 3, np.int32), batch["tokens"][:db, :1])
        counter = dryrun._MetaCounter()
        with counter:
            step(*args)
        for name, c in counter.collectives.items():
            for k in ("calls", "bytes"):
                out[f"{kind}/{name}/{k}"] = c[k]


def ckpt(job, mesh, out, save):
    cfg = config(job)
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    params, opt, specs = state(job, cfg, mesh, tc)
    root = dist.get_rank() == 0
    store = CheckpointStore(job["dir"], CheckpointConfig(keep_last=2),
                            recover=not save) if root else None
    tree = {"params": params, "opt": opt}
    if save:
        step, _ = build_train_step(cfg, job["batch"], job["seq"], tc, "cpu",
                                   mesh=mesh)
        params, opt, _ = step(params, opt, synthetic_batch(
            cfg, 0, job["batch"], job["seq"]))
        tree = {"params": params, "opt": opt}
        save_sharded(store, 1, tree, specs, mesh)
    else:
        zeros = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor)
                 else v for k, v in named_leaves(tree)}
        tree = unflatten(zeros)
        got, tree = restore_sharded(store, tree, specs, mesh)
        out["step"] = got
    out.update(whole(tree, specs, mesh, "s"))


JOBS = {"train": train, "prefill": prefill, "norm": norm, "norm2d": norm2d,
        "model_axis": model_axis, "grads": grads, "decode": decode,
        "gathers": gathers, "collectives": collectives,
        "ckpt_save": lambda job, mesh, out: ckpt(job, mesh, out, True),
        "ckpt_restore": lambda job, mesh, out: ckpt(job, mesh, out, False)}


def run_job(job, out, meshes):
    if job["kind"] == "seq":
        for sub in job["jobs"]:
            res = {}
            run_job(sub, res, meshes)
            out.update({f"{sub['name']}/{k}": v for k, v in res.items()})
        return
    shape = (job.get("pod", 1), job.get("model", 1))
    if shape not in meshes:
        meshes[shape] = make_host_mesh(model=shape[1], pod=shape[0],
                                       device="cpu")
    JOBS[job["kind"]](job, meshes[shape], out)


def main():
    rank, world, store_path, job_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    job = json.loads(open(job_path).read())
    torch.set_num_threads(1)
    runtime.init_group("cpu", dist.FileStore(store_path, world), rank, world,
                       timeout=timedelta(seconds=job.get("timeout", 90)))
    try:
        out = {}
        run_job(job, out, {})
        np.savez(f"{job['out']}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
