"""The dry-run's plan of one device's collectives against the collectives
each process of a real run issues.

``launch.dryrun.plan`` runs one device's step on meta tensors in a fake
process group of the mesh's size and counts every ``c10d`` op it issues.
Here the same steps run for real in a gloo group of 4 processes on a
FileStore (60 s timeouts; ``tests/torch_dist_worker.py``'s
``collectives`` job, one group launch for every mesh), each process
counting its own ``c10d`` ops with the same counter class
(``dryrun._MetaCounter``).  For every mesh, step and rank, the plan on a
fake group of 4 at that rank, the same mesh, shapes and rules, gives the
same calls and the same result bytes of each kind of collective,
exactly.  Rank 0's plan also equals the last rank's in its collectives,
transcendentals and peak, and for olmo-1b in its flops and bytes too:
the dry-run counts rank 0 for every rank.  Where a process's block of a
gathered leaf or of the batch's rows is taken by slices that differ by
rank (Mamba-2's columns of ``w_in``, the MoE's rows), the flops differ
by at most 1e-4 and the unfused bytes by at most 1%.

Meshes (pod, data, model): (4, 1), (2, 2), (1, 4) and the pod mesh
(2, 2, 1).  Steps at SMOKE size: olmo-1b's train (remat "none", and
"full", which gathers each layer again in its recompute and repeats its
tensor-parallel all-reduces), prefill and decode; granite-moe-3b-a800m's
train (the MoE gathers the batch's tokens); mamba2-370m's train and decode
(``gather_blocks``, ``psum``); jamba-v0.1-52b's train at its one block.
Train and prefill take batch 8 × seq 32, decode one token of batch 4
against a cache of 32.
"""

import dataclasses
import functools

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from torch_dist_worker import run_ranks

WORLD, BATCH, SEQ, DECODE_BATCH, MAX_SEQ = 4, 8, 32, 4, 32
# (pod, model) of each mesh, by its (pod, data, model) shape
MESHES = {"4x1": (1, 1), "2x2": (1, 2), "1x4": (1, 4), "2x2x1": (2, 1)}
# (name, arch, config overrides, steps)
RUNS = [("olmo-1b", "olmo-1b", {}, ("train", "prefill", "decode")),
        ("olmo-1b-remat-full", "olmo-1b", {"remat": "full"}, ("train",)),
        ("granite-moe-3b-a800m", "granite-moe-3b-a800m", {}, ("train",)),
        ("mamba2-370m", "mamba2-370m", {}, ("train", "decode")),
        ("jamba-v0.1-52b", "jamba-v0.1-52b", {}, ("train",))]
CASES = [(mesh, name, kind) for mesh in MESHES for name, _, _, steps in RUNS
         for kind in steps]


def _kinds(collectives):
    return {k: (c["calls"], c["bytes"]) for k, c in collectives.items()}


@pytest.fixture(scope="module")
def issued(tmp_path_factory):
    """{(mesh, run name, step kind): [each rank's {collective kind:
    (calls, bytes)}]} from one gloo launch of every mesh and run."""
    jobs = [{"kind": "collectives", "name": f"{mesh}/{name}", "arch": arch,
             "overrides": overrides, "pod": pod, "model": model,
             "steps": list(steps), "batch": BATCH, "seq": SEQ,
             "decode_batch": DECODE_BATCH, "max_seq": MAX_SEQ}
            for mesh, (pod, model) in MESHES.items()
            for name, arch, overrides, steps in RUNS]
    ranks = run_ranks(WORLD, {"kind": "seq", "jobs": jobs, "timeout": 60},
                      tmp_path_factory.mktemp("collectives"))
    out = {}
    for mesh, name, kind in CASES:
        prefix = f"{mesh}/{name}/{kind}/"
        per_rank = []
        for res in ranks:
            got = {}
            for key, v in res.items():
                if key.startswith(prefix):
                    coll, field = key[len(prefix):].split("/")
                    got.setdefault(coll, [0, 0])[field == "bytes"] = int(v)
            per_rank.append({k: tuple(v) for k, v in got.items()})
        out[(mesh, name, kind)] = per_rank
    return out


@functools.lru_cache(maxsize=None)
def _plan(mesh, name, kind, rank):
    _, arch, overrides, _ = next(r for r in RUNS if r[0] == name)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    pod, model = MESHES[mesh]
    b, s = (DECODE_BATCH, MAX_SEQ) if kind == "decode" else (BATCH, SEQ)
    return dryrun.plan(cfg, kind, b, s, model=model, pod=pod, world=WORLD,
                       rank=rank)


@pytest.mark.parametrize("mesh,name,kind", CASES)
def test_plan_equals_the_collectives_each_process_issues(issued, mesh, name,
                                                          kind):
    real = issued[(mesh, name, kind)]
    assert real[0], "the real step issued no collective"
    for rank in range(WORLD):
        p = _plan(mesh, name, kind, rank)
        assert p.mesh_shape == dict(zip(
            ("pod", "data", "model") if MESHES[mesh][0] > 1
            else ("data", "model"),
            tuple(int(x) for x in mesh.split("x"))))
        assert _kinds(p.counter.collectives) == real[rank], rank


@pytest.mark.parametrize("mesh,name,kind", CASES)
def test_rank0_plan_stands_for_the_last_rank(mesh, name, kind):
    first, last = (_plan(mesh, name, kind, r) for r in (0, WORLD - 1))
    for p in (first, last):
        assert p.counter.flops > 0 and p.counter.collectives
    assert first.counter.collectives == last.counter.collectives
    assert (first.counter.transcendentals, first.counter.peak) == \
        (last.counter.transcendentals, last.counter.peak)
    (f0, b0), (f1, b1) = ((p.counter.flops, p.counter.bytes)
                          for p in (first, last))
    if name.startswith("olmo-1b"):
        assert (f0, b0) == (f1, b1)
    else:
        # Mamba-2's head split takes a process's columns of the gathered
        # w_in in one slice or in two (then autograd adds their
        # gradients), and the MoE keeps its rows of the whole batch's by
        # two slices whose backward pads a longer gradient on rank 0: a
        # few flops and unfused bytes that differ by rank
        assert abs(f0 - f1) <= 1e-4 * f1
        assert abs(b0 - b1) <= 1e-2 * b1
