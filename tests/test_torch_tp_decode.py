"""The port's decode step executed across processes on a (data, model)
mesh (``train/step.py``'s ``_sharded_decode_step``): the KV cache split
along its sequence, each token's attention merged over the blocks by
log-sum-exp (``models/modules.py``, ``decode_attention``), and the
Mamba-2 positions on their block of heads (``models/ssm.py``), held
against the JAX ``build_decode_step`` ``jax.jit``ted with the shardings
it returns, on 4 host-CPU devices with the same mesh and rules.

For SMOKE olmo-1b, granite-moe-3b-a800m, qwen2-vl-2b, mamba2-370m and
jamba-v0.1-52b in f32, on (1, 4) and (2, 2) under ``default_rules``
(``cache_seq`` over ``model``, the batch over ``data``), and for
mamba2-370m and jamba on (2, 2) under ``long_context_rules`` (the batch
whole, ``cache_seq`` over ``data`` and ``model``): 3 tokens from a cache
of numpy normal values (a KV cache of batch 4 and max_seq 32, in blocks
of 8 positions or 16), at ragged lengths 2, 9, 17 and 28.  Row 0's whole
sequence lies in the first block, so on every other process its block
holds no valid slot and drops out of the merge only through the block
that holds its last position.  olmo-1b also runs in bf16 on (1, 4), and
with max_seq 30 on (1, 4) (lengths 2, 9, 17, 26): 30 does not divide
over 4, so ``spec_for`` splits the cache's kv heads over ``model`` in
place of its sequence, and each process attends over its kv heads'
whole sequence with no merge.

One JAX process for the module (``XLA_FLAGS`` names the 4 devices before
JAX starts; meshes with Auto axes, ROADMAP F2) runs every case from
JAX's init; the port runs each mesh in one gloo group of 4 processes
(``tests/torch_dist_worker.py``), each process holding its blocks of
the params and of the cache.  Each step's logits and the cache after the
last step, gathered from the processes' blocks, are held to JAX's and to
the port's one-process decode within 1e-5 of the largest magnitude of
each array in f32 (the merge is a different algorithm from the
one-process softmax: the same function within f32 rounding); in bf16, to
``tests/test_torch_model.py``'s bf16 rule (8% of the largest magnitude at
the worst element, 1% on average; ROADMAP F9: JAX rounds the softmax
weights to bf16 before the P·V product, the merge keeps its partial sums
in f32).
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

from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.parallel.sharding import (Mesh, default_rules,
                                           long_context_rules, local_slice,
                                           mesh_coords, shard_shape)
from repro_torch.train import build_decode_step
from repro_torch.train.step import step_specs
from repro_torch.weights import params_from_numpy
from torch_dist_worker import SRC, run_ranks, unflatten

WORLD, BATCH, MAX_SEQ, STEPS = 4, 4, 32, 3
LENGTHS = np.array([2, 9, 17, 28], np.int32)
ARCHS = ["olmo-1b", "granite-moe-3b-a800m", "qwen2-vl-2b", "mamba2-370m",
         "jamba-v0.1-52b"]
MESHES = [(1, 4), (2, 2)]
LONG = ["mamba2-370m", "jamba-v0.1-52b"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _name(shape):
    return f"{shape[0]}x{shape[1]}"


# (arch, mesh, rules, dtype, max_seq)
CASES = ([(arch, shape, "default", "f32", MAX_SEQ) for shape in MESHES
          for arch in ARCHS]
         + [(arch, (2, 2), "long_context", "f32", MAX_SEQ) for arch in LONG]
         + [("olmo-1b", (1, 4), "default", "bf16", MAX_SEQ),
            ("olmo-1b", (1, 4), "default", "f32", 30)])
IDS = [f"{a}-{_name(m)}-{r}-{d}-{s}" for a, m, r, d, s in CASES]


def _lengths(max_seq):
    return np.minimum(LENGTHS, max_seq - STEPS - 1)


def _run(arch, shape, rules, dtype, max_seq):
    return f"{arch}_{_name(shape)}_{rules}_{dtype}_{max_seq}"


_JAX = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models import get_model
    from repro.parallel.sharding import default_rules, long_context_rules
    from repro.train import step as jstep

    out, cases, batch, steps = sys.argv[1:]
    batch, steps = int(batch), int(steps)
    dtypes = {"f32": jnp.float32, "bf16": jnp.bfloat16}

    def flat(tree, prefix=""):
        res = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                res.update(flat(v, f"{prefix}{k}/"))
            else:
                res[prefix + k] = v
        return res

    inits = {}
    for arch, shape, rules, dtype, max_seq, name in json.loads(cases):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=dtypes[dtype])
        if arch not in inits:
            inits[arch] = get_model(cfg).init(cfg, jax.random.PRNGKey(0))
            np.savez(f"{out}/{arch}_init.npz", **{
                k: np.asarray(v) for k, v in flat(inits[arch]).items()})
        data = np.load(f"{out}/{arch}_{max_seq}_data.npz")
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        r = (long_context_rules if rules == "long_context"
             else default_rules)(mesh)
        fn, in_sh, out_sh, abstract = jstep.build_decode_step(
            cfg, mesh, batch, max_seq, r)
        f = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        cache_abs = abstract[1]
        if isinstance(cache_abs, dict):
            cache = {k: jnp.asarray(data[f"cache/{k}"], v.dtype)
                     for k, v in cache_abs.items()}
        else:
            cache = jnp.asarray(data["cache/kv"], cache_abs.dtype)
        p = jax.device_put(inits[arch], in_sh[0])
        cache = jax.device_put(cache, in_sh[1])
        res = {}
        for t in range(steps):
            logits, cache = f(p, cache, jnp.asarray(data[f"lengths{t}"]),
                              jnp.asarray(data[f"tokens{t}"]))
            res[f"logits{t}"] = np.asarray(logits, np.float32)
        for k, v in (cache.items() if isinstance(cache, dict)
                     else [("kv", cache)]):
            res[f"cache/{k}"] = np.asarray(v, np.float32)
        np.savez(f"{out}/{name}.npz", **res)
""")


def _cfg(arch, dtype="f32"):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=DTYPES[dtype])


def _data(arch, max_seq):
    """The whole cache (numpy normal values), and each step's lengths
    (``_lengths`` + t) and tokens."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    _, (_, cache_abs, _, _) = build_decode_step(cfg, BATCH, max_seq,
                                                device="meta")
    items = (cache_abs.items() if isinstance(cache_abs, dict)
             else [("kv", cache_abs)])
    out = {f"cache/{k}": rng.standard_normal(tuple(v.shape))
           .astype(np.float32) for k, v in items}
    for t in range(STEPS):
        out[f"lengths{t}"] = _lengths(max_seq) + t
        out[f"tokens{t}"] = rng.integers(0, cfg.vocab, (BATCH, 1)) \
            .astype(np.int32)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The module's directory: each arch's data, then, from one JAX
    process with 4 host devices, its init and every case's decode."""
    out = tmp_path_factory.mktemp("tp_decode")
    for arch, max_seq in sorted({(c[0], c[4]) for c in CASES}):
        np.savez(out / f"{arch}_{max_seq}_data.npz", **_data(arch, max_seq))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cases = [[a, list(m), r, d, s, _run(a, m, r, d, s)]
             for a, m, r, d, s in CASES]
    res = subprocess.run(
        [sys.executable, "-c", _JAX, str(out), json.dumps(cases),
         str(BATCH), str(STEPS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def port_runs(files, tmp_path_factory):
    """{mesh name: each rank's results}: one gloo group of 4 a mesh, every
    case of that mesh in one launch."""
    runs = {}
    for shape in MESHES:
        jobs = [{"name": _run(a, m, r, d, s), "kind": "decode", "arch": a,
                 "model": m[1], "rules": r,
                 "overrides": {"compute_dtype": d}, "batch": BATCH,
                 "max_seq": s, "steps": STEPS,
                 "init": str(files / f"{a}_init.npz"),
                 "data": str(files / f"{a}_{s}_data.npz")}
                for a, m, r, d, s in CASES if m == shape]
        runs[_name(shape)] = run_ranks(
            WORLD, {"kind": "seq", "jobs": jobs},
            tmp_path_factory.mktemp(_name(shape)))
    return runs


def _gathered(case, ranks):
    """{logits<t>, cache/<k>}: each process's blocks put together at
    ``local_slice`` of the step's specs; two processes that hold one block
    hold the same bits."""
    arch, shape, rules, dtype, max_seq = case
    cfg = _cfg(arch, dtype)
    mesh = Mesh(("data", "model"), shape, "cpu")
    r = (long_context_rules if rules == "long_context"
         else default_rules)(mesh)
    (_, c_spec, _, _), (l_spec, _) = step_specs(cfg, "decode", mesh, BATCH,
                                                max_seq, rules=r)
    _, (_, cache_abs, _, _) = build_decode_step(cfg, BATCH, max_seq,
                                                device="meta")
    shapes = {f"logits{t}": ((BATCH, 1, cfg.vocab), l_spec)
              for t in range(STEPS)}
    if isinstance(cache_abs, dict):
        shapes.update({f"cache/{k}": (tuple(v.shape), c_spec[k])
                       for k, v in cache_abs.items()})
    else:
        shapes["cache/kv"] = (tuple(cache_abs.shape), c_spec)
    name = _run(*case)
    out = {}
    for key, (whole, spec) in shapes.items():
        got = np.full(whole, np.nan, np.float32)
        for rank, res in enumerate(ranks):
            block = res[f"{name}/{key}"]
            assert block.shape == shard_shape(whole, spec, mesh), key
            at = local_slice(whole, spec, mesh, mesh_coords(mesh, rank))
            assert np.isnan(got[at]).all() or np.array_equal(got[at], block)
            got[at] = block
        assert not np.isnan(got).any(), key
        out[key] = got
    return out


@pytest.fixture(scope="module")
def one_runs(files):
    """The port's one-process decode of each arch, dtype and max_seq from
    JAX's init on the same data."""
    cache = {}

    def get(arch, dtype, max_seq):
        if (arch, dtype, max_seq) not in cache:
            cfg = _cfg(arch, dtype)
            params = params_from_numpy(unflatten(dict(
                np.load(files / f"{arch}_init.npz"))), device="cpu")
            data = dict(np.load(files / f"{arch}_{max_seq}_data.npz"))
            step, (_, abs_, _, _) = build_decode_step(cfg, BATCH, max_seq,
                                                      "cpu")
            if isinstance(abs_, dict):
                state = {k: torch.tensor(data[f"cache/{k}"]).to(v.dtype)
                         for k, v in abs_.items()}
            else:
                state = torch.tensor(data["cache/kv"]).to(abs_.dtype)
            out = {}
            for t in range(STEPS):
                logits, state = step(params, state, data[f"lengths{t}"],
                                     data[f"tokens{t}"])
                out[f"logits{t}"] = logits.float().numpy()
            for k, v in (state.items() if isinstance(state, dict)
                         else [("kv", state)]):
                out[f"cache/{k}"] = v.float().numpy()
            cache[(arch, dtype, max_seq)] = out
        return cache[(arch, dtype, max_seq)]
    return get


def _close(got, want, dtype, what):
    for key in want:
        scale = float(np.abs(want[key]).max())
        diff = np.abs(got[key] - want[key])
        if dtype == "f32":
            assert float(diff.max()) <= 1e-5 * scale, \
                (what, key, float(diff.max()), scale)
        else:
            assert float(diff.max()) <= 0.08 * scale, \
                (what, key, float(diff.max()), scale)
            assert float(diff.mean()) <= 0.01 * scale, \
                (what, key, float(diff.mean()), scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_matches_jax_on_the_same_mesh(case, files, port_runs):
    """Each step's logits (each process's block: its rows over ``data``,
    its vocabulary columns over ``model``) and the cache after 3 steps
    (each process's block), put together, against the JAX decode jitted
    with its shardings on the same mesh and rules."""
    got = _gathered(case, port_runs[_name(case[1])])
    want = dict(np.load(files / f"{_run(*case)}.npz"))
    assert sorted(got) == sorted(want)
    _close(got, want, case[3], "jax")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_matches_the_one_process_decode(case, port_runs, one_runs):
    """The same blocks against the port's one-process decode from the
    same state: the merge over the sequence's blocks against one softmax
    over the whole cache, the split heads against the whole layer."""
    got = _gathered(case, port_runs[_name(case[1])])
    _close(got, one_runs(case[0], case[3], case[4]), case[3], "one process")


def test_no_process_holds_the_whole_cache():
    """On (1, 4) and (2, 2), under both rules, every process's block of
    the KV cache holds a quarter of the positions (or a half of them and
    of the rows), and a Mamba-2 SSM state holds a block of the heads;
    ``init_cache_blocks`` allocates that block and nothing more."""
    from repro_torch.train import init_cache_blocks
    for arch in ("jamba-v0.1-52b", "olmo-1b"):
        cfg = _cfg(arch)
        for shape in MESHES:
            mesh = Mesh(("data", "model"), shape, "cpu")
            for rules in (default_rules, long_context_rules):
                r = rules(mesh)
                (_, c_spec, _, _), _ = step_specs(cfg, "decode", mesh,
                                                  BATCH, MAX_SEQ, rules=r)
                kv = c_spec["kv"] if isinstance(c_spec, dict) else c_spec
                whole = (BATCH, MAX_SEQ)
                block = shard_shape((1, 2) + whole + (cfg.kv_heads,
                                                      cfg.head_dim),
                                    kv, mesh)[2:4]
                assert block[0] * block[1] * 4 == whole[0] * whole[1], \
                    (arch, shape, rules.__name__, kv)
                if isinstance(c_spec, dict):
                    assert "model" in c_spec["ssm"]
    # a plain Mesh plans and holds no group: the whole cache
    cfg = _cfg("jamba-v0.1-52b")
    mesh = Mesh(("data", "model"), (2, 2), "cpu")
    cache = init_cache_blocks(cfg, BATCH, MAX_SEQ, mesh, device="cpu")
    want = get_model(cfg).init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_a_row_within_the_first_block_is_covered():
    """The data holds a row (row 0, length 2 + t) whose whole sequence
    lies in the first block of 8 positions on every mesh and rules here,
    and rows whose last position lies in the second, third and fourth:
    every process's block holds some row's last position and some row's
    block holds no valid slot."""
    blocks = {(int(n) // 8) for t in range(STEPS) for n in LENGTHS + t}
    assert blocks == {0, 1, 2, 3}
    assert all(int(LENGTHS[0]) + t < 8 for t in range(STEPS))
