"""Mamba-2's head split on the mesh's ``model`` axis (``models/ssm.py``):
mamba2-370m's and jamba-v0.1-52b's train and prefill steps executed
across processes on (1, 4) and (2, 2), held against the JAX steps
``jax.jit``ted with the shardings their step functions return, on 4
host-CPU devices with the same mesh, and against the port's one-process
step.

Under ``default_rules`` the port splits ``w_in`` over ``inner_all``,
``a_log``, ``d_skip`` and ``dt_bias`` over ``ssm_heads``, ``out_norm``
and ``w_out``'s rows over ``inner``, as JAX does; each process runs the
layer on its block of heads (K4's plain version at H/m heads here), with
``w_in``'s blocks, which do not fall on its components (296 columns, 74
a block on 4, where z alone is 128), gathered whole and their gradient
summed over ``model`` into each block, and the gated norm's sum of
squares summed over ``model``.  jamba's attention, dense FFN and experts
split as in ``tests/test_torch_tp.py``.

Cases: SMOKE mamba2-370m and jamba, f32 compute, batch 8, seq 32, 2
steps at lr 1e-3 from JAX's init, and the prefill on the first batch;
and mamba2-370m with ``ssm_state`` 17 on (1, 4), where ``spec_for``
leaves ``w_in`` (298 columns) whole and splits the heads.  The bounds
are ``tests/test_torch_tp.py``'s f32 ones: the loss to 1e-5 relative,
the grad norm to 1e-4, the params after the last step to 2·lr·steps at
the worst element and to 1e-5 at all but a 1e-3 share; the
prefill's logits, gathered, to 1e-5 of the largest |logit|.  jamba's
gradient is ill conditioned at one block (ROADMAP F7): after the first
AdamW step, which moves each element by ±lr on the sign of its gradient,
f32 order flips the sign of enough near-zero elements that the second
step parts, as F18 found for qwen2-vl-2b.  So jamba's bounds are raised
by ``tests/test_torch_tp.py``'s rule for qwen2-vl-2b: to twice the
port's one-process step's own distance from the JAX step on the same
mesh (each step's loss and grad norm, the share of params more than
1e-5 apart, the prefill's logits) where that is larger, in both
comparisons; and its grad norm at least to 1e-2, as
``tests/test_torch_dist_port.py`` holds it.  Also: every gradient leaf
of one step on (1, 4) against ``jax.grad`` of JAX's loss, within 1e-5 of
the leaf's largest magnitude or twice the port's one-process gradient's
distance from JAX's, whichever is larger (``w_in``'s among them: a
gradient taken as a block without the sum over ``model`` is off by its
other processes' parts, a large share of the leaf's magnitude), a run
with every Mamba-2 leaf whole on (1, 4) against one process, and a
mamba2-370m checkpoint saved from (2, 2) restored with its bits by one
process.

One JAX process for the module (4 host devices, Auto axes, ROADMAP F2);
the port runs each mesh in one gloo group of 4 processes
(``tests/torch_dist_worker.py``).
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
from repro_torch.models import get_model
from repro_torch.parallel.sharding import Mesh
from repro_torch.train import (AdamWConfig, TrainConfig, build_prefill_step,
                               build_train_step, init_state, synthetic_batch)
from repro_torch.train.step import step_specs
from repro_torch.weights import params_from_numpy
from test_torch_tp import (_check, _gathered_logits, _name, _same_state,
                           _spread, _sub)
from torch_dist_worker import SRC, run_ranks, unflatten

WORLD, BATCH, SEQ, STEPS, LR = 4, 8, 32, 2, 1e-3
MESHES = [(1, 4), (2, 2)]
# (name, arch, overrides, meshes)
RUNS = [("mamba2-370m", "mamba2-370m", {}, MESHES),
        ("jamba-v0.1-52b", "jamba-v0.1-52b", {}, MESHES),
        ("mamba2-st17", "mamba2-370m", {"ssm_state": 17}, [(1, 4)])]
# every Mamba-2 leaf whole on a model axis of 4: 6 heads of 21, d_inner
# 126, w_in 290 columns
ALL_WHOLE = {"d_model": 63, "ssm_headdim": 21}

_JAX = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import get_model
    from repro.train import optimizer, step as jstep

    out, runs, batch, seq, steps, lr = sys.argv[1:]
    batch, seq, steps, lr = int(batch), int(seq), int(steps), float(lr)

    def flat(tree, prefix=""):
        res = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                res.update(flat(v, f"{prefix}{k}/"))
            else:
                res[prefix + k] = v
        return res

    for name, arch, overrides, meshes in json.loads(runs):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=jnp.float32, **overrides)
        model = get_model(cfg)
        params0 = model.init(cfg, jax.random.PRNGKey(0))
        np.savez(f"{out}/{name}_init.npz",
                 **{k: np.asarray(v) for k, v in flat(params0).items()})
        batches = np.load(f"{out}/{name}_batches.npz")
        b0 = {k.split("/")[1]: jnp.asarray(batches[k])
              for k in batches.files if k.startswith("0/")}
        g = jax.jit(jax.grad(lambda p: model.loss_fn(p, b0, cfg)))(params0)
        np.savez(f"{out}/{name}_grads.npz",
                 **{"g/" + k: np.asarray(v) for k, v in flat(g).items()})
        for shape in meshes:
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:shape[0] * shape[1]])
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
            b = {k: v for k, v in b0.items() if k != "targets"}
            res["logits"] = np.asarray(f(jax.device_put(params0, in_sh[0]),
                                         b))
            np.savez(f"{out}/{name}_{shape[0]}x{shape[1]}.npz", **res)
""")


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, **kw)


def _step_batches(arch):
    return [synthetic_batch(_cfg(arch), i, BATCH, SEQ) for i in range(STEPS)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each run's batches, then, from one JAX process with 4 host devices,
    its init, its gradient at the init on the first batch and its steps
    and prefill on each mesh."""
    out = tmp_path_factory.mktemp("tp_ssm")
    for name, arch, _, _ in RUNS:
        np.savez(out / f"{name}_batches.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(_step_batches(arch))
                    for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", _JAX, str(out), json.dumps(RUNS), str(BATCH),
         str(SEQ), str(STEPS), str(LR)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def _case(files, name, arch, overrides, kind, model, **extra):
    return dict({"name": f"{kind}/{name}", "kind": kind, "arch": arch,
                 "model": model,
                 "overrides": dict(overrides, compute_dtype="f32"),
                 "batch": BATCH, "seq": SEQ, "steps": STEPS, "lr": LR,
                 "init": str(files / f"{name}_init.npz"),
                 "batches": str(files / f"{name}_batches.npz")}, **extra)


@pytest.fixture(scope="module")
def port_runs(files, tmp_path_factory):
    """{mesh name: each rank's results}: one gloo group of 4 a mesh, run
    one after the other: every run's train and prefill; on (1, 4) also
    the gradients of one step and the run with every Mamba-2 leaf whole;
    on (2, 2) a mamba2-370m checkpoint saved."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    runs = {}
    for shape in MESHES:
        m = shape[1]
        jobs = []
        for name, arch, overrides, meshes in RUNS:
            if list(shape) not in [list(x) for x in meshes]:
                continue
            jobs.append(_case(files, name, arch, overrides, "train", m))
            jobs.append(_case(files, name, arch, overrides, "prefill", m))
            if m == 4:
                jobs.append(_case(files, name, arch, overrides, "grads", m))
        if m == 4:
            jobs.append(_case(files, "whole", "mamba2-370m", ALL_WHOLE,
                              "train", m, init=None, batches=str(
                                  files / "mamba2-370m_batches.npz")))
        else:
            jobs.append({"name": "ckpt_save", "kind": "ckpt_save",
                         "arch": "mamba2-370m", "batch": BATCH, "seq": SEQ,
                         "model": m, "dir": str(ckpt / "2x2")})
        runs[_name(shape)] = run_ranks(
            WORLD, {"kind": "seq", "jobs": jobs},
            tmp_path_factory.mktemp(_name(shape)))
    runs["ckpt"] = ckpt
    return runs


@pytest.fixture(scope="module")
def one_runs(files):
    """The port's one-process step of a run (from JAX's init, or its own
    seeded one): each step's loss and grad norm, the params after the
    last step and the prefill's logits on the first batch."""
    cache = {}

    def get(name, arch, overrides, init="jax"):
        if (name, init) not in cache:
            cfg = _cfg(arch, **overrides)
            tc = TrainConfig(adamw=AdamWConfig(lr=LR))
            if init == "jax":
                params = params_from_numpy(unflatten(dict(np.load(
                    files / f"{name}_init.npz"))), device="cpu")
            else:
                params = get_model(cfg).init(
                    cfg, torch.Generator().manual_seed(0), "cpu")
            batches = _step_batches(arch)
            prefill, _ = build_prefill_step(cfg, BATCH, SEQ, "cpu")
            out = {"logits": prefill(params, {
                k: v for k, v in batches[0].items() if k != "targets"
            }).numpy()}
            step, _ = build_train_step(cfg, BATCH, SEQ, tc, "cpu")
            opt = init_state(params, tc.adamw)
            for i, batch in enumerate(batches):
                params, opt, m = step(params, opt, batch)
                out.update({f"{k}{i}": float(v) for k, v in m.items()})
            out.update({f"p/{k}": v.numpy()
                        for k, v in named_leaves(params)})
            cache[(name, init)] = out
        return cache[(name, init)]
    return get


def _check_run(run, shape, got, want, files, one_runs):
    """``_check``, with jamba's bounds raised to twice the port's
    one-process step's distance from the JAX step on ``shape`` and its
    grad norm to at least 1e-2 (F7)."""
    floor = None
    if run[0] == "jamba-v0.1-52b":
        jax_run = dict(np.load(files / f"{run[0]}_{_name(shape)}.npz"))
        floor = _spread(one_runs(*run[:3]), jax_run)
        for i in range(STEPS):
            k = f"grad_norm{i}"
            floor[k] = max(floor[k], 0.5e-2 * abs(float(want[k])))
    _check(got, want, floor)


CASES = [(run, shape) for run in RUNS for shape in run[3]]
IDS = [f"{run[0]}-{_name(shape)}" for run, shape in CASES]


@pytest.mark.parametrize("run,shape", CASES, ids=IDS)
def test_train_step_matches_jax_on_the_same_mesh(run, shape, files,
                                                 port_runs, one_runs):
    """2 steps in a gloo group of 4: each step's loss and grad norm, and
    every param leaf gathered after the last step, against the JAX step on
    the same mesh; the metrics equal on every process."""
    name = run[0]
    ranks = port_runs[_name(shape)]
    got = _sub(ranks[0], f"train/{name}")
    assert tuple(got["mesh"]) == shape
    _check_run(run, shape, got,
               dict(np.load(files / f"{name}_{_name(shape)}.npz")), files,
               one_runs)
    for out in ranks[1:]:
        other = _sub(out, f"train/{name}")
        for i in range(STEPS):
            for k in (f"loss{i}", f"grad_norm{i}"):
                assert other[k] == got[k], (k, other[k], got[k])


@pytest.mark.parametrize("run,shape", CASES, ids=IDS)
def test_train_step_matches_the_one_process_step(run, shape, files,
                                                 port_runs, one_runs):
    """The same run against the port's one-process step from the same
    state."""
    got = _sub(port_runs[_name(shape)][0], f"train/{run[0]}")
    _check_run(run, shape, got, one_runs(*run[:3]), files, one_runs)


@pytest.mark.parametrize("run,shape", CASES, ids=IDS)
def test_prefill_matches_jax_and_one_process(run, shape, files, port_runs,
                                             one_runs):
    """Each process's block of the last token's logits, put together,
    against JAX's on the same mesh and the one-process prefill, within
    1e-5 of the largest |logit|."""
    name, arch, overrides, _ = run
    want = dict(np.load(files / f"{name}_{_name(shape)}.npz"))["logits"]
    ranks = [{k.replace(f"prefill/{name}/", f"prefill/{arch}/"): v
              for k, v in out.items()} for out in port_runs[_name(shape)]]
    got = _gathered_logits(arch, shape, ranks, want.shape[1])
    one = one_runs(*run[:3])["logits"]
    scale = float(np.abs(want).max())
    bound = 1e-5 * scale
    if name == "jamba-v0.1-52b":
        bound = max(bound, 2 * float(np.abs(one - want).max()))
    assert float(np.abs(got - want).max()) <= bound
    assert float(np.abs(got - one).max()) <= bound


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_gradients_on_1x4_match_jax(run, files, port_runs):
    """Every gradient leaf of one step on (1, 4) (the blocks summed over
    ``data`` and gathered whole) against ``jax.grad`` of JAX's loss at
    the same init on the same batch, within 1e-5 of the leaf's largest
    magnitude or twice the port's one-process gradient's distance from
    JAX's, whichever is larger.  ``w_in``'s gradient is the sum over
    ``model`` of each process's part (its own heads' z, x and dt columns,
    and its share of B's and C's); without that sum each block holds only
    its own process's part."""
    name, arch, overrides, _ = run
    got = _sub(port_runs["1x4"][0], f"grads/{name}")
    want = dict(np.load(files / f"{name}_grads.npz"))
    names = sorted(k for k in want if k.startswith("g/"))
    assert names == sorted(k for k in got if k.startswith("g/"))
    assert any(k.endswith("/w_in") for k in names)
    cfg = _cfg(arch, **overrides)
    params = params_from_numpy(unflatten(dict(np.load(
        files / f"{name}_init.npz"))), device="cpu")
    leaves = [p.requires_grad_() for _, p in named_leaves(params)]
    batch = {k: torch.from_numpy(v)
             for k, v in _step_batches(arch)[0].items()}
    one = torch.autograd.grad(get_model(cfg).loss_fn(params, batch, cfg),
                              leaves, allow_unused=True,
                              materialize_grads=True)
    one = {f"g/{k}": g.numpy() for (k, _), g in zip(named_leaves(params),
                                                    one)}
    for k in names:
        scale = float(np.abs(want[k]).max())
        bound = max(1e-5 * scale, 2 * float(np.abs(one[k] - want[k]).max()))
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= bound, (k, err, bound, scale)


def test_spec_for_fallbacks_on_1x4():
    """The cases the fallback runs cover: with ``ssm_state`` 17 ``w_in``
    is whole over ``model`` and the heads split; with ``ALL_WHOLE`` every
    Mamba-2 leaf is whole."""
    mesh = Mesh(("data", "model"), (1, 4), "cpu")

    def layer_specs(**kw):
        cfg = _cfg("mamba2-370m", **kw)
        (p_spec, _, _), _ = step_specs(cfg, "train", mesh, BATCH, SEQ)
        return {k: tuple(v) for k, v in p_spec["layers"].items()}
    split = layer_specs()
    assert split["w_in"] == (None, "data", "model")
    assert split["a_log"] == (None, "model")
    st17 = layer_specs(ssm_state=17)
    assert st17["w_in"] == (None, "data") and st17["a_log"] == (None, "model")
    whole = layer_specs(**ALL_WHOLE)
    assert not any("model" in spec for spec in whole.values())


def test_every_mamba2_leaf_whole_on_1x4(port_runs, one_runs):
    """mamba2-370m with every Mamba-2 leaf whole over ``model`` (6 heads on
    4): each process runs the whole layer alike, the embedding and the
    unembedding still split; the f32 bounds against one process from the
    same seeded init."""
    got = _sub(port_runs["1x4"][0], "train/whole")
    _check(got, one_runs("whole", "mamba2-370m", ALL_WHOLE, init="seed"))


def test_a_mamba2_checkpoint_from_2x2_restores_on_one_process(port_runs):
    """The mamba2-370m state saved on (2, 2) after one step (its heads,
    ``w_in`` columns and ``d_inner`` rows split over ``model``) restores
    in the one-process store with its bits in every leaf of params, both
    moments and count."""
    want = _sub(port_runs["2x2"][0], "ckpt_save")
    step, flat = CheckpointStore(str(port_runs["ckpt"] / "2x2"),
                                 recover=True).restore()
    assert step == 1
    assert any(k.endswith("/w_in") for k in want)
    _same_state({f"s/{k}": np.asarray(v) for k, v in flat.items()}, want)


def test_heads_and_d_inner_that_split_differently_raise():
    """With 2 heads of 64 on a model axis of 4, ``spec_for`` leaves the
    heads whole and splits ``d_inner`` (128): ``out_norm``'s and
    ``w_out``'s blocks would not cover one block of heads, so the layer
    refuses to run rather than compute on misaligned channels.  With 8
    heads of 16 both split, over the same channels."""
    from repro_torch.models import ssm
    from repro_torch.parallel.ctx import activation_rules
    from repro_torch.parallel.sharding import default_rules
    mesh = Mesh(("data", "model"), (1, 4), "cpu")
    group = object()      # model_split reads the group, never calls it
    with activation_rules(mesh, default_rules(mesh), None, group):
        with pytest.raises(NotImplementedError, match="split differently"):
            ssm._head_split(_cfg("mamba2-370m", ssm_headdim=64))
        hs = ssm._head_split(_cfg("mamba2-370m"))
    assert (hs.size, hs.block(8)) == (4, (0, 2))
