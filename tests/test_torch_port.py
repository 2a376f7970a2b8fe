"""The port as a package: no JAX at run time, configs and weights that
match the JAX package's, and entry points that never run on the CPU unless
asked to."""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh, serve, train
from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models.modules import ParamSpec, materialize
from repro_torch.serving import PagedCacheConfig, PagedKVCache
from repro_torch.train import (build_decode_step, build_prefill_step,
                               build_train_step)
from repro_torch.weights import params_from_numpy

SRC = Path(__file__).resolve().parents[1] / "src"
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          None: None}


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith"
        "(('jax.', 'jaxlib')) or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 16      # every module was imported


def test_archs_are_the_jax_packages():
    assert set(ARCHS) == set(J_ARCHS) and len(ARCHS) == len(set(ARCHS))


@pytest.mark.parametrize("arch", ["olmo-1b", "phi3-mini-3.8b",
                                  "starcoder2-3b", "phi3-medium-14b",
                                  "mamba2-370m", "granite-moe-3b-a800m",
                                  "grok-1-314b", "jamba-v0.1-52b",
                                  "qwen2-vl-2b", "hubert-xlarge"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_jax(arch, smoke):
    want, got = j_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if f.name.endswith("_dtype"):
            w = DTYPES[w]
        assert getattr(got, f.name) == w, f.name
    assert got.head_dim == want.head_dim
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,model", [("olmo-1b", transformer),
                                        ("mamba2-370m", ssm),
                                        ("granite-moe-3b-a800m", transformer),
                                        ("jamba-v0.1-52b", hybrid),
                                        ("qwen2-vl-2b", transformer),
                                        ("hubert-xlarge", transformer)])
def test_params_from_numpy_round_trips_jax_init(arch, model):
    cfg = j_get_config(arch, smoke=True)
    params = j_get_model(cfg).init(cfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    got = _flat(params_from_numpy(tree, device="cpu"))
    want = _flat(tree)
    assert sorted(got) == sorted(want)
    # the port's own spec tree has the same names and shapes
    spec = _flat(model.init(get_config(arch, smoke=True),
                            torch.Generator().manual_seed(0), device="cpu"))
    assert {k: tuple(v.shape) for k, v in spec.items()} == \
        {k: v.shape for k, v in want.items()}
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), w)


def test_materialize_shape_dtype_and_scale():
    tree = {"a": ParamSpec((400, 300), ("x", "y"), scale=2.0),
            "b": {"c": ParamSpec((64,), ("x",))}}
    p = materialize(tree, torch.Generator().manual_seed(0), device="cpu")
    assert p["a"].shape == (400, 300) and p["a"].dtype == torch.float32
    assert p["b"]["c"].shape == (64,)
    std = 2.0 / math.sqrt(400)          # scale / sqrt(fan_in = shape[0])
    # 120k draws: the sample std is within 1% of the true one with margin
    # to spare (its relative sd is ~0.2%), the mean within 5 sd of 0.
    assert abs(float(p["a"].std()) / std - 1) < 0.01
    assert abs(float(p["a"].mean())) < 5 * std / math.sqrt(400 * 300)
    q = materialize(tree, torch.Generator().manual_seed(0), device="cpu",
                    param_dtype=torch.bfloat16)
    assert q["a"].dtype == torch.bfloat16


ENTRY_POINTS = {
    "make_host_mesh": lambda: mesh.make_host_mesh(),
    "transformer.init": lambda: transformer.init(
        get_config("olmo-1b", smoke=True), torch.Generator()),
    "materialize": lambda: materialize(
        {"w": ParamSpec((4, 4), ("x", "y"))}, torch.Generator()),
    "params_from_numpy": lambda: params_from_numpy(
        {"w": np.zeros((2, 2), np.float32)}),
    "PagedKVCache": lambda: PagedKVCache(
        get_config("olmo-1b", smoke=True), PagedCacheConfig(n_pages=8)),
    "serve.main": lambda: serve.main(["--arch", "olmo-1b"]),
    "init_cache": lambda: transformer.init_cache(
        get_config("olmo-1b", smoke=True), 1, 8),
    "build_prefill_step": lambda: build_prefill_step(
        get_config("olmo-1b", smoke=True), 1, 8),
    "build_decode_step": lambda: build_decode_step(
        get_config("olmo-1b", smoke=True), 1, 8),
    "ssm.init": lambda: ssm.init(
        get_config("mamba2-370m", smoke=True), torch.Generator()),
    "ssm.init_cache": lambda: ssm.init_cache(
        get_config("mamba2-370m", smoke=True), 1),
    "build_prefill_step mamba2": lambda: build_prefill_step(
        get_config("mamba2-370m", smoke=True), 1, 16),
    "build_decode_step mamba2": lambda: build_decode_step(
        get_config("mamba2-370m", smoke=True), 1, 16),
    "build_train_step": lambda: build_train_step(
        get_config("olmo-1b", smoke=True), 1, 8),
    "build_train_step mamba2": lambda: build_train_step(
        get_config("mamba2-370m", smoke=True), 1, 16),
    "train.main": lambda: train.main(["--smoke", "--steps", "1"]),
    "hybrid.init": lambda: hybrid.init(
        get_config("jamba-v0.1-52b", smoke=True), torch.Generator()),
    "hybrid.init_cache": lambda: hybrid.init_cache(
        get_config("jamba-v0.1-52b", smoke=True), 1, 8),
    "build_train_step jamba": lambda: build_train_step(
        get_config("jamba-v0.1-52b", smoke=True), 1, 16),
    "build_decode_step jamba": lambda: build_decode_step(
        get_config("jamba-v0.1-52b", smoke=True), 1, 16),
    "build_prefill_step qwen2-vl": lambda: build_prefill_step(
        get_config("qwen2-vl-2b", smoke=True), 1, 16),
    "build_train_step hubert": lambda: build_train_step(
        get_config("hubert-xlarge", smoke=True), 1, 16),
    "train.main jamba": lambda: train.main(
        ["--arch", "jamba-v0.1-52b", "--smoke", "--steps", "1"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_refuse_to_run_on_cpu_unasked(name, monkeypatch):
    # As on a machine with no card, whatever this one has.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
