"""The mesh's ``pod`` axis executed: ``make_host_mesh(model=m, pod=p)``
builds a (pod, data, model) mesh with a group for each axis and one for
the batch's (pod, data); the batch splits over (pod, data) by rows in the
combined coordinate's row-major order, the params are FSDP blocks over
``data`` and replicated over ``pod`` (a gradient reduce-scattered over
``data`` in the backward, then all-reduced over ``pod``), and the masked
mean loss and the MoE's routing run over the batch's group.

Held against the JAX steps ``jax.jit``ted with their builders'
shardings on 4 host-CPU devices with the same (pod, data, model) mesh and
``default_rules`` (one JAX process, Auto axes, ROADMAP F2), on (2, 2, 1)
and (2, 1, 2), in f32, from JAX's init: SMOKE olmo-1b and
granite-moe-3b-a800m (its first rows repeating one token, so the
forward drops pairs and the rows of one (pod, data) coordinate crowd out
another's: ``tests/test_torch_tp.py``'s batches), 2 train steps at lr
1e-3, batch 8, seq 32; the prefill on the first batch; 3 decode tokens
(batch 4, a cache of max_seq 32 of numpy normal values); and olmo-1b's
decode under ``long_context_rules`` on (2, 2, 1), the batch whole and
the cache's sequence split over all three axes.  The bounds are
``tests/test_torch_tp.py``'s f32 ones; the MoE's routes on every process
equal to the port's one-process step's.

Checkpoints: ``save_sharded`` and ``restore_sharded`` take a pod mesh as
they take any other (every process gathers each whole tensor, the
process of rank 0, at pod coordinate 0, writes them; every pod restores
its blocks): a state saved on (2, 2, 1) restores with its bits on
(2, 1, 2) and in the one-process store, and one saved on (2, 1, 2)
restores on (2, 2, 1).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore, named_leaves
from repro_torch.configs import get_config
from repro_torch.parallel.sharding import (Mesh, default_rules,
                                           long_context_rules, local_slice,
                                           mesh_coords, shard_shape)
from repro_torch.train import (AdamWConfig, TrainConfig, build_decode_step,
                               build_train_step, init_state)
from repro_torch.train.step import step_specs
from repro_torch.weights import params_from_numpy
from test_torch_tp import _batches, _check, _same_state, _sub
from torch_dist_worker import SRC, recording_routes, run_ranks, unflatten

WORLD, BATCH, SEQ, STEPS, LR = 4, 8, 32, 2, 1e-3
AXES = ("pod", "data", "model")
ARCHS = ["olmo-1b", "granite-moe-3b-a800m"]
MOE = "granite-moe-3b-a800m"
MESHES = [(2, 2, 1), (2, 1, 2)]
DECODE_BATCH, MAX_SEQ, DECODE_STEPS = 4, 32, 3
LENGTHS = np.array([2, 9, 17, 28], np.int32)
# (arch, mesh, rules) of each decode
DECODES = ([(arch, shape, "default") for shape in MESHES for arch in ARCHS]
           + [("olmo-1b", (2, 2, 1), "long_context")])

_JAX = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import get_model
    from repro.parallel.sharding import default_rules, long_context_rules
    from repro.train import optimizer, step as jstep

    out, archs, meshes, decodes, batch, seq, steps, lr, dbatch, max_seq, \\
        dsteps = sys.argv[1:]
    batch, seq, steps, lr = int(batch), int(seq), int(steps), float(lr)
    dbatch, max_seq, dsteps = int(dbatch), int(max_seq), int(dsteps)

    def flat(tree, prefix=""):
        res = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                res.update(flat(v, f"{prefix}{k}/"))
            else:
                res[prefix + k] = v
        return res

    def make(shape):
        return jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                             axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:4])

    inits = {}
    for arch in json.loads(archs):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=jnp.float32)
        inits[arch] = params0 = get_model(cfg).init(cfg,
                                                    jax.random.PRNGKey(0))
        np.savez(f"{out}/{arch}_init.npz",
                 **{k: np.asarray(v) for k, v in flat(params0).items()})
        batches = np.load(f"{out}/{arch}_batches.npz")
        for shape in json.loads(meshes):
            mesh = make(shape)
            tc = jstep.TrainConfig(adamw=optimizer.AdamWConfig(lr=lr))
            fn, in_sh, out_sh, _ = jstep.build_train_step(cfg, mesh, batch,
                                                          seq, tc)
            f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
            p = jax.device_put(params0, in_sh[0])
            o = jax.device_put(optimizer.init_state(params0, tc.adamw),
                               in_sh[1])
            res = {}
            for i in range(steps):
                b = {k.split("/")[1]: jnp.asarray(batches[k])
                     for k in batches.files if k.startswith(f"{i}/")}
                p, o, m = f(p, o, b)
                res[f"loss{i}"] = np.asarray(m["loss"])
                res[f"grad_norm{i}"] = np.asarray(m["grad_norm"])
            res.update({"p/" + k: np.asarray(v) for k, v in flat(p).items()})
            fn, in_sh, out_sh, _ = jstep.build_prefill_step(cfg, mesh, batch,
                                                            seq)
            f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
            b = {k.split("/")[1]: jnp.asarray(batches[k])
                 for k in batches.files
                 if k.startswith("0/") and not k.endswith("/targets")}
            res["logits"] = np.asarray(f(jax.device_put(params0, in_sh[0]),
                                         b))
            np.savez(f"{out}/{arch}_{'x'.join(map(str, shape))}.npz", **res)
    for arch, shape, rules, name in json.loads(decodes):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=jnp.float32)
        data = np.load(f"{out}/{arch}_decode.npz")
        mesh = make(shape)
        r = (long_context_rules if rules == "long_context"
             else default_rules)(mesh)
        fn, in_sh, out_sh, abstract = jstep.build_decode_step(
            cfg, mesh, dbatch, max_seq, r)
        f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        cache = jax.device_put(jnp.asarray(data["cache/kv"],
                                           abstract[1].dtype), in_sh[1])
        p = jax.device_put(inits[arch], in_sh[0])
        res = {}
        for t in range(dsteps):
            logits, cache = f(p, cache, jnp.asarray(data[f"lengths{t}"]),
                              jnp.asarray(data[f"tokens{t}"]))
            res[f"logits{t}"] = np.asarray(logits, np.float32)
        res["cache/kv"] = np.asarray(cache, np.float32)
        np.savez(f"{out}/{name}.npz", **res)
""")


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, **kw)


def _name(shape):
    return "x".join(map(str, shape))


def _decode_name(arch, shape, rules):
    return f"decode_{arch}_{_name(shape)}_{rules}"


def _mesh(shape):
    return Mesh(AXES, shape, "cpu")


def _rules(rules, mesh):
    return (long_context_rules if rules == "long_context"
            else default_rules)(mesh)


def _decode_data(arch):
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    _, (_, cache_abs, _, _) = build_decode_step(cfg, DECODE_BATCH, MAX_SEQ,
                                                device="meta")
    out = {"cache/kv": rng.standard_normal(tuple(cache_abs.shape))
           .astype(np.float32)}
    for t in range(DECODE_STEPS):
        out[f"lengths{t}"] = LENGTHS + t
        out[f"tokens{t}"] = rng.integers(0, cfg.vocab, (DECODE_BATCH, 1)) \
            .astype(np.int32)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each arch's batches and decode data, then, from one JAX process
    with 4 host devices, its init and its runs on each pod mesh."""
    out = tmp_path_factory.mktemp("pod")
    for arch in ARCHS:
        np.savez(out / f"{arch}_batches.npz", **_batches(arch))
        np.savez(out / f"{arch}_decode.npz", **_decode_data(arch))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    decodes = [[a, list(m), r, _decode_name(a, m, r)] for a, m, r in DECODES]
    res = subprocess.run(
        [sys.executable, "-c", _JAX, str(out), json.dumps(ARCHS),
         json.dumps(MESHES), json.dumps(decodes), str(BATCH), str(SEQ),
         str(STEPS), str(LR), str(DECODE_BATCH), str(MAX_SEQ),
         str(DECODE_STEPS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def port_runs(files, tmp_path_factory):
    """{mesh name: each rank's results}: one gloo group of 4 a pod mesh,
    (2, 2, 1) first: every arch's train and prefill, the decodes of that
    mesh, and a checkpoint saved after one step; then on (2, 1, 2) also
    that checkpoint restored, and a checkpoint of its own saved, which a
    last group restores on (2, 2, 1)."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    runs = {}
    for shape in MESHES:
        pod, model = shape[0], shape[2]
        jobs = []
        for arch in ARCHS:
            case = {"arch": arch, "pod": pod, "model": model,
                    "overrides": {"compute_dtype": "f32"}, "batch": BATCH,
                    "seq": SEQ, "steps": STEPS, "lr": LR,
                    "init": str(files / f"{arch}_init.npz"),
                    "batches": str(files / f"{arch}_batches.npz")}
            jobs.append(dict(case, name=f"train/{arch}", kind="train"))
            jobs.append(dict(case, name=f"prefill/{arch}", kind="prefill"))
        for arch, m, rules in DECODES:
            if tuple(m) == shape:
                jobs.append({"name": _decode_name(arch, m, rules),
                             "kind": "decode", "arch": arch, "pod": pod,
                             "model": model, "rules": rules,
                             "overrides": {"compute_dtype": "f32"},
                             "batch": DECODE_BATCH, "max_seq": MAX_SEQ,
                             "steps": DECODE_STEPS,
                             "init": str(files / f"{arch}_init.npz"),
                             "data": str(files / f"{arch}_decode.npz")})
        ck = {"arch": "olmo-1b", "batch": BATCH, "seq": SEQ, "pod": pod,
              "model": model}
        jobs.append(dict(ck, name="ckpt_save", kind="ckpt_save",
                         dir=str(ckpt / _name(shape))))
        if shape != MESHES[0]:
            jobs.append(dict(ck, name="ckpt_restore", kind="ckpt_restore",
                             dir=str(ckpt / _name(MESHES[0]))))
        runs[_name(shape)] = run_ranks(
            WORLD, {"kind": "seq", "jobs": jobs},
            tmp_path_factory.mktemp(_name(shape)))
    first = MESHES[0]
    runs["restore"] = run_ranks(
        WORLD, {"kind": "ckpt_restore", "arch": "olmo-1b", "batch": BATCH,
                "seq": SEQ, "pod": first[0], "model": first[2],
                "dir": str(ckpt / _name(MESHES[1]))},
        tmp_path_factory.mktemp("restore"))
    runs["ckpt"] = ckpt
    return runs


@pytest.fixture(scope="module")
def one_runs(files):
    """The port's one-process train step of each arch from JAX's init on
    the same batches, and for the MoE the experts each token kept."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tc = TrainConfig(adamw=AdamWConfig(lr=LR))
        step, _ = build_train_step(cfg, BATCH, SEQ, tc, "cpu")
        params = params_from_numpy(unflatten(dict(np.load(
            files / f"{arch}_init.npz"))), device="cpu")
        opt = init_state(params, tc.adamw)
        flat = _batches(arch)
        res, routes = {}, []
        with recording_routes(routes):
            for i in range(STEPS):
                batch = {k.split("/")[1]: v for k, v in flat.items()
                         if k.startswith(f"{i}/")}
                params, opt, m = step(params, opt, batch)
                res.update({f"{k}{i}": float(v) for k, v in m.items()})
        if routes:
            res["routes"] = np.stack(routes)
        out[arch] = res
    return out


def _assemble(whole, spec, mesh, blocks):
    got = np.full(whole, np.nan, np.float32)
    for rank, block in enumerate(blocks):
        at = local_slice(whole, spec, mesh, mesh_coords(mesh, rank))
        assert block.shape == shard_shape(whole, spec, mesh)
        assert np.isnan(got[at]).all() or np.array_equal(got[at], block)
        got[at] = block
    assert not np.isnan(got).any()
    return got


CASES = [(arch, shape) for shape in MESHES for arch in ARCHS]
IDS = [f"{arch}-{_name(shape)}" for arch, shape in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_matches_jax_on_the_pod_mesh(arch, shape, files,
                                                port_runs):
    """2 steps: each step's loss and grad norm, and every param leaf
    gathered after the last step, against the JAX step on the same
    (pod, data, model) mesh; the metrics equal on every process; every
    process holds its blocks, none split over ``pod``."""
    ranks = port_runs[_name(shape)]
    got = _sub(ranks[0], f"train/{arch}")
    assert tuple(got["mesh"]) == shape
    _check(got, dict(np.load(files / f"{arch}_{_name(shape)}.npz")))
    mesh = _mesh(shape)
    (p_spec, _, _), _ = step_specs(_cfg(arch), "train", mesh, BATCH, SEQ)
    assert not any("pod" in str(spec) for _, spec in named_leaves(p_spec))
    for out in ranks[1:]:
        other = _sub(out, f"train/{arch}")
        for i in range(STEPS):
            for k in (f"loss{i}", f"grad_norm{i}"):
                assert other[k] == got[k], (k, other[k], got[k])


@pytest.mark.parametrize("shape", MESHES, ids=[_name(m) for m in MESHES])
def test_moe_routes_over_the_batch_of_both_axes(shape, port_runs,
                                                one_runs):
    """At every routing of the granite run, every process keeps each
    token's pairs in the experts the one-process step keeps them in: the
    MoE gathers the tokens of every (pod, data) coordinate, in the
    batch's row order."""
    want = one_runs[MOE]["routes"]
    for r, out in enumerate(port_runs[_name(shape)]):
        got = out[f"train/{MOE}/routes"]
        assert got.shape == want.shape, (r, got.shape, want.shape)
        assert int((got != want).any(-1).sum()) == 0, r


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_prefill_matches_jax_on_the_pod_mesh(arch, shape, files,
                                             port_runs):
    """Each process's block of the last token's logits (its rows over
    (pod, data), its vocabulary columns over ``model``), put together,
    against JAX's within 1e-5 of the largest |logit|."""
    mesh = _mesh(shape)
    _, out_spec = step_specs(_cfg(arch), "prefill", mesh, BATCH, SEQ)
    want = dict(np.load(files / f"{arch}_{_name(shape)}.npz"))["logits"]
    got = _assemble(want.shape, out_spec, mesh,
                    [out[f"prefill/{arch}/logits"]
                     for out in port_runs[_name(shape)]])
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())


@pytest.mark.parametrize("case", DECODES,
                         ids=[f"{a}-{_name(m)}-{r}" for a, m, r in DECODES])
def test_decode_matches_jax_on_the_pod_mesh(case, files, port_runs):
    """3 tokens: each token's logits and the cache after the last, put
    together from the processes' blocks, against the JAX decode on the
    same mesh and rules within 1e-5 of each array's largest magnitude;
    under ``long_context_rules`` the cache's sequence is split over
    ``pod``, ``data`` and ``model``, a quarter of it a process."""
    arch, shape, rules = case
    mesh = _mesh(shape)
    r = _rules(rules, mesh)
    (_, c_spec, _, _), (l_spec, _) = step_specs(_cfg(arch), "decode", mesh,
                                                DECODE_BATCH, MAX_SEQ,
                                                rules=r)
    if rules == "long_context":
        assert tuple(c_spec)[3] == AXES
    name = _decode_name(*case)
    want = dict(np.load(files / f"{name}.npz"))
    ranks = port_runs[_name(shape)]
    for key, arr in want.items():
        spec = c_spec if key.startswith("cache") else l_spec
        got = _assemble(arr.shape, spec, mesh,
                        [out[f"{name}/{key}"] for out in ranks])
        assert float(np.abs(got - arr).max()) <= \
            1e-5 * float(np.abs(arr).max()), key


def test_a_checkpoint_saved_on_a_pod_mesh_restores_elsewhere(port_runs):
    """The olmo-1b state saved on (2, 2, 1) after one step restores with
    its bits in every leaf of params, both moments and count on (2, 1, 2)
    and in the one-process store; the one saved on (2, 1, 2) restores on
    (2, 2, 1)."""
    want = _sub(port_runs["2x2x1"][0], "ckpt_save")
    for out in port_runs["2x1x2"]:
        got = _sub(out, "ckpt_restore")
        assert int(got["step"]) == 1
        _same_state(got, want)
    step, flat = CheckpointStore(str(port_runs["ckpt"] / "2x2x1"),
                                 recover=True).restore()
    assert step == 1
    _same_state({f"s/{k}": np.asarray(v) for k, v in flat.items()}, want)
    want = _sub(port_runs["2x1x2"][0], "ckpt_save")
    for out in port_runs["restore"]:
        assert int(out["step"]) == 1
        _same_state(out, want)
