"""FSDP weights gathered one layer at a time: the port's train, prefill
and decode steps on a mesh that runs hand the params to the model as
blocks split over ``data``, and each layer (each jamba position; the
embedding and the unembedding) gathers its own leaves whole over
``data`` when it runs (``parallel.ctx.gather_params``,
``runtime.gather_data``), its gradient reduce-scattered into the block in
the backward, one layer at a time, as XLA gathers FSDP weights per layer
inside the JAX package's layer scan.

Held against the JAX steps ``jax.jit``ted with the shardings their
builders return, on 4 host-CPU devices with the same mesh (one JAX
process for the module, Auto axes, ROADMAP F2, run while the port's
groups run), for SMOKE olmo-1b, mamba2-370m and jamba-v0.1-52b on (4, 1)
and (2, 2) in f32, from the port's seeded init: 2 train steps at lr 1e-3
with 1 and with 2 microbatches, on batch 8, seq 32; the prefill on the
first batch; 3 decode tokens (batch 4, a cache of max_seq 32 of numpy
normal values, lengths 2, 9, 17, 28).  jamba's JAX step takes ~15 s to
compile, so jamba runs 1 microbatch on (4, 1) and 2 on (2, 2), and its
prefill and decode on (4, 1): its 1 microbatch, prefill and decode on
(2, 2) are ``tests/test_torch_tp_ssm.py``'s and
``test_torch_tp_decode.py``'s cases, through the same per-layer gathers.
The port runs each mesh in one gloo group of 4 processes
(``tests/torch_dist_worker.py``).  Bounds are ``tests/test_torch_tp.py``'s:
the loss to 1e-5 relative, the grad norm to 1e-4, the params after the
last step to 2·lr·steps at the worst element and to 1e-5 at all but a
1e-3 share, the prefill's and each decode token's logits, gathered, to
1e-5 of the largest |logit|.  jamba's train and prefill bounds are
raised by ``tests/test_torch_tp_ssm.py``'s rule (ROADMAP F7): to twice
the port's one-process step's own distance from the JAX step on the same
mesh where that is larger, its grad norm at least to 1e-2.

And the gathers themselves, read from ``runtime.gathered`` on (4, 1) and
(2, 2), for olmo-1b and mamba2-370m at 4 layers and jamba at its one
block of 8 positions: no step gathers the whole layer stack; the bytes
alive at once never exceed one layer's (one position's) plus the
top-level leaves'; under remat "full" the train step gathers every
layer twice (forward and recompute), under "none" once; the prefill and
each decode token once; and nothing gathered stays alive after a step.
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

from repro_torch.checkpoint import named_leaves
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.parallel import runtime
from repro_torch.parallel.sharding import (Mesh, PartitionSpec, local_slice,
                                           mesh_coords, shard_shape)
from repro_torch.train import (AdamWConfig, TrainConfig, build_decode_step,
                               build_prefill_step, build_train_step,
                               init_state, synthetic_batch)
from repro_torch.train.step import step_specs
from repro_torch.weights import params_from_numpy
from test_torch_tp import _check, _spread, _sub
from torch_dist_worker import SRC, run_ranks, unflatten

WORLD, BATCH, SEQ, STEPS, LR = 4, 8, 32, 2, 1e-3
ARCHS = ["olmo-1b", "mamba2-370m", "jamba-v0.1-52b"]
MESHES = [(4, 1), (2, 2)]
MICRO = [1, 2]
# ill conditioned at one block (ROADMAP F7): bounds raised as in
# tests/test_torch_tp_ssm.py
F7 = "jamba-v0.1-52b"
DECODE_BATCH, MAX_SEQ, DECODE_STEPS = 4, 32, STEPS + 1
LENGTHS = np.array([2, 9, 17, 28], np.int32)
# the gathers' test: layers where the arch has a stack of them
GATHER_LAYERS = {"olmo-1b": 4, "mamba2-370m": 4}
# (arch, mesh, microbatches) of each train run, and (arch, mesh) of each
# prefill and decode
TRAINS = [(arch, shape, m) for shape in MESHES for arch in ARCHS
          for m in MICRO
          if arch != F7 or (shape, m) in (((4, 1), 1), ((2, 2), 2))]
CALLS = [(arch, shape) for shape in MESHES for arch in ARCHS
         if arch != F7 or shape == (4, 1)]

_JAX = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.train import optimizer, step as jstep

    out, archs, trains, calls, batch, seq, steps, lr, dbatch, max_seq, \\
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

    def unflat(arrays):
        tree = {}
        for name in arrays.files:
            node = tree
            *path, leaf = name.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(arrays[name])
        return tree

    def mesh_of(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch, smoke=True),
                                   compute_dtype=jnp.float32)

    params0 = {a: unflat(np.load(f"{out}/{a}_init.npz"))
               for a in json.loads(archs)}
    for arch, shape, m in json.loads(trains):
        cfg = cfg_of(arch)
        batches = np.load(f"{out}/{arch}_batches.npz")
        tc = jstep.TrainConfig(microbatches=m,
                               adamw=optimizer.AdamWConfig(lr=lr))
        fn, in_sh, out_sh, _ = jstep.build_train_step(cfg, mesh_of(shape),
                                                      batch, seq, tc)
        f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        p = jax.device_put(params0[arch], in_sh[0])
        o = jax.device_put(optimizer.init_state(params0[arch], tc.adamw),
                           in_sh[1])
        res = {}
        for i in range(steps):
            b = {k.split("/")[1]: jnp.asarray(batches[k])
                 for k in batches.files if k.startswith(f"{i}/")}
            p, o, mt = f(p, o, b)
            res[f"loss{i}"] = np.asarray(mt["loss"])
            res[f"grad_norm{i}"] = np.asarray(mt["grad_norm"])
        res.update({"p/" + k: np.asarray(v) for k, v in flat(p).items()})
        np.savez(f"{out}/train_{arch}_{shape[0]}x{shape[1]}_m{m}.npz", **res)
    for arch, shape in json.loads(calls):
        cfg, mesh = cfg_of(arch), mesh_of(shape)
        batches = np.load(f"{out}/{arch}_batches.npz")
        data = np.load(f"{out}/{arch}_decode.npz")
        fn, in_sh, out_sh, _ = jstep.build_prefill_step(cfg, mesh, batch,
                                                        seq)
        f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        b = {k.split("/")[1]: jnp.asarray(batches[k])
             for k in batches.files
             if k.startswith("0/") and not k.endswith("/targets")}
        res = {"logits": np.asarray(f(jax.device_put(params0[arch],
                                                     in_sh[0]), b))}
        fn, in_sh, out_sh, abstract = jstep.build_decode_step(
            cfg, mesh, dbatch, max_seq)
        f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        cache_abs = abstract[1]
        if isinstance(cache_abs, dict):
            cache = {k: jnp.asarray(data[f"cache/{k}"], v.dtype)
                     for k, v in cache_abs.items()}
        else:
            cache = jnp.asarray(data["cache/kv"], cache_abs.dtype)
        p = jax.device_put(params0[arch], in_sh[0])
        cache = jax.device_put(cache, in_sh[1])
        for t in range(dsteps):
            logits, cache = f(p, cache, jnp.asarray(data[f"lengths{t}"]),
                              jnp.asarray(data[f"tokens{t}"]))
            res[f"logits{t}"] = np.asarray(logits, np.float32)
        np.savez(f"{out}/calls_{arch}_{shape[0]}x{shape[1]}.npz", **res)
""")


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, **kw)


def _name(shape):
    return f"{shape[0]}x{shape[1]}"


def _step_batches(arch):
    return [synthetic_batch(_cfg(arch), i, BATCH, SEQ) for i in range(STEPS)]


def _decode_data(arch):
    """The whole decode cache (numpy normal values), and each token's
    lengths and tokens."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    _, (_, cache_abs, _, _) = build_decode_step(cfg, DECODE_BATCH, MAX_SEQ,
                                                device="meta")
    items = (cache_abs.items() if isinstance(cache_abs, dict)
             else [("kv", cache_abs)])
    out = {f"cache/{k}": rng.standard_normal(tuple(v.shape))
           .astype(np.float32) for k, v in items}
    for t in range(DECODE_STEPS):
        out[f"lengths{t}"] = LENGTHS + t
        out[f"tokens{t}"] = rng.integers(0, cfg.vocab, (DECODE_BATCH, 1)) \
            .astype(np.int32)
    return out


def _init(arch):
    """The port's seeded init, as numpy arrays under ``/``-joined names."""
    cfg = _cfg(arch)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    return {k: v.numpy() for k, v in named_leaves(params)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(the module's directory, the JAX process): each arch's init,
    batches and decode data, then one JAX process with 4 host devices,
    started here, which writes every train run and call on its mesh."""
    out = tmp_path_factory.mktemp("fsdp")
    for arch in ARCHS:
        np.savez(out / f"{arch}_init.npz", **_init(arch))
        np.savez(out / f"{arch}_batches.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(_step_batches(arch))
                    for k, v in b.items()})
        np.savez(out / f"{arch}_decode.npz", **_decode_data(arch))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(out), json.dumps(ARCHS),
         json.dumps(TRAINS), json.dumps(CALLS), str(BATCH), str(SEQ),
         str(STEPS), str(LR), str(DECODE_BATCH), str(MAX_SEQ),
         str(DECODE_STEPS)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        yield out, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_runs(files, tmp_path_factory):
    """{mesh name: each rank's results}: one gloo group of 4 a mesh, while
    the JAX process runs: the mesh's train runs, prefills, decodes and
    every arch's gathers."""
    out, _ = files
    runs = {}
    for shape in MESHES:
        jobs = []
        for arch in ARCHS:
            case = {"arch": arch, "model": shape[1],
                    "overrides": {"compute_dtype": "f32"}, "batch": BATCH,
                    "seq": SEQ, "steps": STEPS, "lr": LR,
                    "init": str(out / f"{arch}_init.npz"),
                    "batches": str(out / f"{arch}_batches.npz")}
            for m in MICRO:
                if (arch, shape, m) in TRAINS:
                    jobs.append(dict(case, name=f"m{m}/{arch}",
                                     kind="train", microbatches=m))
            if (arch, shape) in CALLS:
                jobs.append(dict(case, name=f"prefill/{arch}",
                                 kind="prefill"))
                jobs.append(dict(case, name=f"decode/{arch}", kind="decode",
                                 batch=DECODE_BATCH, max_seq=MAX_SEQ,
                                 steps=DECODE_STEPS,
                                 data=str(out / f"{arch}_decode.npz")))
            layers = GATHER_LAYERS.get(arch)
            jobs.append({"name": f"gathers/{arch}", "kind": "gathers",
                         "arch": arch, "model": shape[1], "batch": BATCH,
                         "seq": SEQ, "overrides": {
                             "compute_dtype": "f32",
                             **({"n_layers": layers} if layers else {})}})
        runs[_name(shape)] = run_ranks(
            WORLD, {"kind": "seq", "jobs": jobs},
            tmp_path_factory.mktemp(_name(shape)))
    return runs


@pytest.fixture(scope="module")
def jax_runs(files, port_runs):
    """{name: arrays} of every JAX run: ``train_<arch>_<mesh>_m<m>`` and
    ``calls_<arch>_<mesh>``, once its process (started with the module's
    files, running while the port's groups run) has ended."""
    out, proc = files
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return {p.stem: dict(np.load(p)) for kind in ("train", "calls")
            for p in out.glob(f"{kind}_*.npz")}


@pytest.fixture(scope="module")
def one_runs(files):
    """The port's one-process steps of jamba (F7's floor) from the same
    init on the same batches: {m: each step's loss and grad norm and the
    params after the last step}, and the prefill's logits."""
    cfg = _cfg(F7)
    params0 = unflatten(dict(np.load(files[0] / f"{F7}_init.npz")))
    out = {}
    batches = _step_batches(F7)
    for m in MICRO:
        tc = TrainConfig(microbatches=m, adamw=AdamWConfig(lr=LR))
        step, _ = build_train_step(cfg, BATCH, SEQ, tc, "cpu")
        params = params_from_numpy(params0, device="cpu")
        opt = init_state(params, tc.adamw)
        res = {}
        for i, batch in enumerate(batches):
            params, opt, mt = step(params, opt, batch)
            res.update({f"{k}{i}": float(v) for k, v in mt.items()})
        res.update({f"p/{k}": v.numpy() for k, v in named_leaves(params)})
        out[m] = res
    prefill, _ = build_prefill_step(cfg, BATCH, SEQ, "cpu")
    out["logits"] = prefill(params_from_numpy(params0, device="cpu"), {
        k: v for k, v in batches[0].items() if k != "targets"}).numpy()
    return out


def _assemble(whole, spec, mesh, blocks):
    """The whole array from every process's block at ``local_slice`` of
    ``spec``; two processes that hold one block hold the same bits."""
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


@pytest.mark.parametrize("arch,shape,m", TRAINS, ids=[
    f"{a}-{_name(s)}-micro{m}" for a, s, m in TRAINS])
def test_train_step_matches_jax(arch, shape, m, jax_runs, port_runs,
                                one_runs):
    """2 steps with m microbatches: each step's loss and grad norm, and
    every param leaf gathered after the last step, against the JAX step
    on the same mesh; the metrics equal on every process."""
    ranks = port_runs[_name(shape)]
    got = _sub(ranks[0], f"m{m}/{arch}")
    assert tuple(got["mesh"]) == shape
    assert int(got["count"]) == STEPS
    want = jax_runs[f"train_{arch}_{_name(shape)}_m{m}"]
    floor = None
    if arch == F7:
        floor = _spread(one_runs[m], want)
        for i in range(STEPS):
            k = f"grad_norm{i}"
            floor[k] = max(floor[k], 0.5e-2 * abs(float(want[k])))
    _check(got, want, floor)
    for out in ranks[1:]:
        other = _sub(out, f"m{m}/{arch}")
        for i in range(STEPS):
            for k in (f"loss{i}", f"grad_norm{i}"):
                assert other[k] == got[k], (k, other[k], got[k])


@pytest.mark.parametrize("arch,shape", CALLS, ids=[
    f"{a}-{_name(s)}" for a, s in CALLS])
def test_prefill_matches_jax(arch, shape, jax_runs, port_runs, one_runs):
    """The prefill's blocks of the last token's logits, put together,
    against JAX's within 1e-5 of the largest |logit| (jamba: or twice the
    one-process prefill's distance from them, where larger)."""
    cfg = _cfg(arch)
    mesh = Mesh(("data", "model"), shape, "cpu")
    _, out_spec = step_specs(cfg, "prefill", mesh, BATCH, SEQ)
    want = jax_runs[f"calls_{arch}_{_name(shape)}"]["logits"]
    got = _assemble(want.shape, out_spec, mesh,
                    [out[f"prefill/{arch}/logits"]
                     for out in port_runs[_name(shape)]])
    bound = 1e-5 * float(np.abs(want).max())
    if arch == F7:
        bound = max(bound, 2 * float(np.abs(one_runs["logits"] - want).max()))
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("arch,shape", CALLS, ids=[
    f"{a}-{_name(s)}" for a, s in CALLS])
def test_decode_matches_jax(arch, shape, jax_runs, port_runs):
    """3 decode tokens from the same cache: each token's logits, put
    together from the processes' blocks, against JAX's within 1e-5 of the
    largest |logit|."""
    cfg = _cfg(arch)
    mesh = Mesh(("data", "model"), shape, "cpu")
    _, (l_spec, _) = step_specs(cfg, "decode", mesh, DECODE_BATCH, MAX_SEQ)
    want = jax_runs[f"calls_{arch}_{_name(shape)}"]
    for t in range(DECODE_STEPS):
        w = want[f"logits{t}"]
        got = _assemble(w.shape, l_spec, mesh,
                        [out[f"decode/{arch}/logits{t}"]
                         for out in port_runs[_name(shape)]])
        assert float(np.abs(got - w).max()) <= \
            1e-5 * float(np.abs(w).max()), t


def _gathered_sizes(arch, shape):
    """(the bytes of each layer's (each jamba position's) gathered
    leaves, the top-level leaves' gathered bytes): a leaf split over
    ``data`` is gathered whole over ``data`` and stays its block over
    ``model``."""
    layers = GATHER_LAYERS.get(arch)
    cfg = _cfg(arch, **({"n_layers": layers} if layers else {}))
    mesh = Mesh(("data", "model"), shape, "cpu")
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, BATCH, SEQ)
    whole = dict(named_leaves(get_model(cfg).specs(cfg)))
    per_layer, top = {}, 0
    for name, spec in named_leaves(p_spec):
        if runtime.data_dim(spec) is None:
            continue
        model = PartitionSpec(*[e if e == "model" else None for e in spec])
        nbytes = 4 * int(np.prod(shard_shape(whole[name].shape, model,
                                             mesh)))
        stack, _, rest = name.partition("/")
        if stack == "layers":
            per_layer["layers"] = per_layer.get("layers", 0) + nbytes
        elif stack == "blocks":
            pos = rest.split("/")[0]
            per_layer[pos] = per_layer.get(pos, 0) + nbytes
        else:
            top += nbytes
    n = cfg.n_layers if "layers" in per_layer else \
        cfg.n_layers // cfg.attn_every
    return {k: v // n for k, v in per_layer.items()}, n, top


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_layer_is_gathered_in_its_turn(arch, shape, port_runs):
    """``runtime.gathered`` on every rank: the train step under remat
    "full" gathers each layer's (each position's) leaves twice, its
    forward and its recompute, and the top-level leaves once; under
    "none" each once; the prefill and one decode token each once.  The
    gathered bytes alive at once never exceed the largest layer's (or
    position's) plus the top-level leaves', far less than the whole layer
    stack's, so no step gathers the stack whole; none stay alive after a
    step."""
    layer, n, top = _gathered_sizes(arch, shape)
    stack = n * sum(layer.values())
    bound = max(layer.values()) + top
    assert bound < stack + top
    want = {"train_full": 2 * stack + top, "train_none": stack + top,
            "prefill": stack + top, "decode": stack + top}
    for out in port_runs[_name(shape)]:
        got = _sub(out, f"gathers/{arch}")
        for kind, nbytes in want.items():
            assert int(got[f"{kind}/bytes"]) == nbytes, (kind, nbytes)
            assert int(got[f"{kind}/live"]) == 0, kind
            if kind != "train_none":
                assert int(got[f"{kind}/peak"]) <= bound, \
                    (kind, int(got[f"{kind}/peak"]), bound, stack)
        # under "none" the saved products keep every layer until the
        # backward: more alive at once than under "full"
        assert int(got["train_none/peak"]) > int(got["train_full/peak"])
