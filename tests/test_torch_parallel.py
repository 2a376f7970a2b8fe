"""The port's ``parallel/`` and ``launch/{mesh,shapes}`` against the JAX
package, on the CPU: ``spec_for`` on the sharding tests' cases and on
every arch's full param tree, ``step_specs`` against the JAX step
builders' shardings on the production meshes (one subprocess with 512
host devices), the int8 collectives bit for bit (``int8_allreduce`` in a
4-process gloo group), ``constrain``, ``shapes.cells`` and
``param_bytes``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import shapes as j_shapes
from repro.models import get_model as j_get_model
from repro.models import registry as j_registry
from repro.parallel import collectives as j_coll
from repro.parallel import sharding as j_sharding
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import shapes as t_shapes
from repro_torch.models import get_model, registry
from repro_torch.parallel import (activation_rules, constrain,
                                  default_rules, int8_quantize,
                                  long_context_rules, spec_for,
                                  tree_shardings)
from repro_torch.parallel.sharding import Mesh, PartitionSpec, shard_shape
from repro_torch.train.step import _meta_params, step_specs

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


class _FakeMesh:
    """What the JAX ``spec_for`` reads of a mesh (tests/test_sharding.py)."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _both(name):
    names, sizes = MESHES[name]
    return _FakeMesh(names, sizes), Mesh(names, sizes)


def test_spec_for_matches_the_sharding_tests_cases():
    jm, tm = _both("16x16")
    rules = {"heads": "model", "kv_heads": "model", "embed": "data",
             "batch": ("data",)}
    cases = [((6144, 48, 128), ("embed", "heads", None)),
             ((6144, 8, 128), ("embed", "kv_heads", None)),
             ((48, 48), ("heads", "heads"))]
    for shape, axes in cases:
        want = j_sharding.spec_for(shape, axes, rules, jm)
        assert tuple(spec_for(shape, axes, rules, tm)) == tuple(want)
    assert tuple(spec_for((6144, 48, 128), ("embed", "heads", None), rules,
                          tm)) == ("data", "model")
    jm, tm = _both("2x16x16")
    got = spec_for((256, 4096), ("batch", None), {"batch": ("pod", "data")},
                   tm)
    assert tuple(got) == tuple(j_sharding.spec_for(
        (256, 4096), ("batch", None), {"batch": ("pod", "data")}, jm)) \
        == tuple(JP(("pod", "data")))
    assert tm.devices.size == 512 and tm.size == 512
    assert tm.shape == {"pod": 2, "data": 16, "model": 16}


def test_partition_spec_trims_trailing_nones():
    assert tuple(PartitionSpec("data", None, None)) == ("data",)
    assert tuple(PartitionSpec(None, ("pod", "data"))) == \
        (None, ("pod", "data"))
    assert PartitionSpec() == ()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", J_ARCHS)
def test_param_specs_match_jax(arch, mesh):
    """Every leaf of the full param tree, under both rule sets."""
    jm, tm = _both(mesh)
    jc, tc = j_get_config(arch), get_config(arch)
    jmod, tmod = j_get_model(jc), get_model(tc)
    t_abs = _meta_params(tmod.specs(tc), tc.param_dtype)
    j_abs = jmod.init(jc, abstract=True)
    for j_rules, t_rules in [(j_sharding.default_rules, default_rules),
                             (j_sharding.long_context_rules,
                              long_context_rules)]:
        want = _flat(j_sharding.tree_specs(j_abs, jmod.logical_axes(jc),
                                           j_rules(jm), jm))
        got = _flat(tree_shardings(t_abs, tmod.logical_axes(tc),
                                   t_rules(tm), tm))
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k]) == tuple(want[k]), k


def test_shard_shape():
    _, tm = _both("2x16x16")
    assert shard_shape((256, 4096, 2048), PartitionSpec(("pod", "data")),
                       tm) == (8, 4096, 2048)
    assert shard_shape((64, 32, 48), PartitionSpec(None, "data", "model"),
                       tm) == (64, 2, 3)
    with pytest.raises(ValueError):
        shard_shape((10,), PartitionSpec("model"), tm)


# ---------------------------------------------------------------------------
# step_specs against the JAX builders' shardings, every runnable cell on
# both production meshes (512 host devices: a subprocess of its own)
# ---------------------------------------------------------------------------

_FLAT = textwrap.dedent("""
    def to_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def flat(tree, prefix, leaf):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(flat(tree[k], f"{prefix}{k}/", leaf))
            return out
        if isinstance(tree, (list, tuple)) and not leaf(tree):
            out = {}
            for i, v in enumerate(tree):
                out.update(flat(v, f"{prefix}{i}/", leaf))
            return out
        return {prefix: to_json(tree if leaf(tree) else tree.spec)}
""")

_JAX_STEP_SPECS = _FLAT + textwrap.dedent("""
    import json
    from jax.sharding import NamedSharding
    from repro.configs import ARCHS, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.shapes import SHAPES, cells
    from repro.parallel.sharding import default_rules, long_context_rules
    from repro.train.step import (build_decode_step, build_prefill_step,
                                  build_train_step)

    runnable, _ = cells(ARCHS)
    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch, shape in runnable:
            cfg, spec = get_config(arch), SHAPES[shape]
            rules = (long_context_rules(mesh) if shape == "long_500k"
                     else default_rules(mesh))
            build = {"train": build_train_step, "prefill": build_prefill_step,
                     "decode": build_decode_step}[spec.kind]
            args = (cfg, mesh, spec.global_batch, spec.seq)
            if spec.kind == "train":
                _, ins, outs, _ = build(*args, None, rules)
            else:
                _, ins, outs, _ = build(*args, rules)
            leaf = lambda x: False
            out[f"{arch} {shape} {mp}"] = [flat(ins, "", leaf),
                                           flat(outs, "", leaf)]
    print(json.dumps(out))
""")


def test_step_specs_match_the_jax_builders_shardings():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", _JAX_STEP_SPECS], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    ns = {}
    exec(_FLAT, ns)
    runnable, _ = t_shapes.cells(ARCHS)
    assert len(want) == 2 * len(runnable)
    for mp in (False, True):
        mesh = t_mesh.make_production_mesh(multi_pod=mp)
        for arch, shape in runnable:
            cfg, spec = get_config(arch), t_shapes.SHAPES[shape]
            rules = (long_context_rules(mesh) if shape == "long_500k"
                     else default_rules(mesh))
            ins, outs = step_specs(cfg, spec.kind, mesh, spec.global_batch,
                                   spec.seq, rules=rules)
            leaf = lambda x: isinstance(x, PartitionSpec)
            got = [ns["flat"](ins, "", leaf), ns["flat"](outs, "", leaf)]
            # JSON turns the tuples of a spec entry into lists, both sides
            got = json.loads(json.dumps(got))
            assert got == want[f"{arch} {shape} {mp}"], (arch, shape, mp)


# ---------------------------------------------------------------------------
# int8 collectives
# ---------------------------------------------------------------------------

def _bits(x):
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("shape,scale", [((4, 128), 1.0), ((1000,), 3e-3),
                                         ((7, 33), 250.0)])
def test_int8_quantize_is_bit_equal_to_jax(shape, scale):
    x = (np.random.default_rng(len(shape)).normal(size=shape) * scale) \
        .astype(np.float32)
    jq, js = j_coll.int8_quantize(jnp.asarray(x))
    tq, ts = int8_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()).tobytes() == _bits(np.asarray(js)).tobytes()


_WORKER = textwrap.dedent("""
    import sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import int8_allreduce
    rank, world, store_path, x_path, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    x = torch.from_numpy(np.load(x_path)[rank])
    y = int8_allreduce(x)
    assert torch.equal(x, torch.from_numpy(np.load(x_path)[rank]))
    np.save(out_path, y.numpy())
    dist.destroy_process_group()
""")


def test_int8_allreduce_in_a_gloo_group_is_bit_equal_to_jax(tmp_path):
    """Four processes, each holding one row of the reference test's (4,
    128) input (tests/test_kernels.py), against ``jax.vmap`` of the JAX
    ``int8_allreduce`` over an axis of 4."""
    world = 4
    xs = np.random.default_rng(42).normal(size=(world, 128)) \
        .astype(np.float32)
    np.save(tmp_path / "x.npy", xs)
    want = np.asarray(jax.vmap(lambda x: j_coll.int8_allreduce(x, "i"),
                               axis_name="i")(jnp.asarray(xs)))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / "x.npy"),
         str(tmp_path / f"out{r}.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=60)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, errs
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npy")
        assert got.dtype == np.float32
        assert _bits(got).tobytes() == _bits(want[r]).tobytes(), r
    # the mean within the quantisation bound, as the reference test holds it
    assert np.abs(want[0] - xs.mean(0)).max() <= 4 * np.abs(xs).max() / 127


# ---------------------------------------------------------------------------
# constrain, meshes, shapes, param_bytes
# ---------------------------------------------------------------------------

def test_constrain_is_the_identity_that_checks_its_axes():
    x = torch.ones(4, 8, 16)
    assert constrain(x, ("act_batch", None)) is x     # no scope: no check
    tm = Mesh(("data", "model"), (2, 2))
    with activation_rules(tm, default_rules(tm)):
        assert constrain(x, ("act_batch", None, None)) is x
        with pytest.raises(AssertionError):
            constrain(x, ("act_batch", None))
    assert constrain(x, ("act_batch", None)) is x     # the scope is gone


def test_production_and_host_meshes():
    m = t_mesh.make_production_mesh()
    assert (m.axis_names, m.shape, m.devices.size) == \
        (("data", "model"), {"data": 16, "model": 16}, 256)
    m = t_mesh.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.devices.size) == (("pod", "data", "model"), 512)
    m = t_mesh.make_host_mesh(device="cpu")
    assert (m.shape, m.device_type) == ({"data": 1, "model": 1}, "cpu")
    with pytest.raises(ValueError):
        t_mesh.make_host_mesh(model=2, device="cpu")


def test_shapes_and_cells_match_jax():
    assert {k: tuple(vars(v).values()) for k, v in t_shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in j_shapes.SHAPES.items()}
    assert t_shapes.cells(ARCHS) == j_shapes.cells(J_ARCHS)
    for arch in ARCHS:
        for s in t_shapes.SHAPES:
            assert t_shapes.skip_reason(get_config(arch), s) == \
                j_shapes.skip_reason(j_get_config(arch), s)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_param_bytes_match_jax(arch):
    for n in (1, 2, 4):
        assert registry.param_bytes(get_config(arch), n) == \
            j_registry.param_bytes(j_get_config(arch), n)
    assert registry.param_bytes(get_config(arch)) == \
        j_registry.param_bytes(j_get_config(arch))
