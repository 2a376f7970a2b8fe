"""The port's checkpoint store against the JAX package's: the reference
tests on torch trees, checkpoints that one package writes and the other
restores bit for bit from the same directory, and the port's copy of the
Scavenger+ engine held to its source file by file."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import CheckpointStore as JCheckpointStore
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.train import optimizer as j_opt
from repro_torch.checkpoint import (CheckpointConfig, CheckpointStore,
                                    named_leaves)
from repro_torch.train import AdamWConfig, apply_updates, init_state
from repro_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ENGINE_PKGS = ("core", "store", "obs", "bench")


def _engine_files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for pkg in ENGINE_PKGS
                  for p in (root / pkg).glob("*.py"))


ENGINE = _engine_files(SRC / "repro_torch")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bits(x) -> np.ndarray:
    """The raw bytes of a tensor or array, as uint8 (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_same_bits(got, want):
    g, w = dict(named_leaves(got)), dict(named_leaves(want))
    assert sorted(g) == sorted(w)
    for name in w:
        assert tuple(g[name].shape) == tuple(w[name].shape), name
        assert str(g[name].dtype).split(".")[-1] == str(w[name].dtype), name
        np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]),
                                      err_msg=name)


# -- the reference's store tests (tests/test_checkpoint.py), on torch trees --

def test_roundtrip_retention_and_recovery(tmp_path):
    root = str(tmp_path / "ckpt")
    st = CheckpointStore(root, CheckpointConfig(keep_last=2))
    tree = {"w": torch.arange(300000, dtype=torch.float32).reshape(100, 3000),
            "b": {"x": torch.ones((7,), dtype=torch.float32)}}
    for step in (10, 20, 30):
        tree["w"] = tree["w"] + step
        st.save(step, tree, extra={"loss": 1.0 / step})
    assert st.steps() == [20, 30]          # keep_last=2 enforced

    s, flat = st.restore()
    assert s == 30
    np.testing.assert_array_equal(flat["w"], tree["w"].numpy())
    np.testing.assert_array_equal(flat["b/x"], tree["b"]["x"].numpy())

    like = {"w": torch.zeros(100, 3000), "b": {"x": torch.zeros(7)}}
    s, nested = st.restore(like=like)
    assert nested is like                  # restored in place
    assert torch.equal(nested["b"]["x"], tree["b"]["x"])
    assert torch.equal(nested["w"], tree["w"])

    # deleted checkpoints become garbage the engine reclaims
    st.db.flush_all()
    assert st.db.space_usage()["global_garbage_ratio"] < 0.3

    # crash restart: new process opens the same directory
    st2 = CheckpointStore(root, CheckpointConfig(keep_last=2), recover=True)
    s2, flat2 = st2.restore()
    assert s2 == 30
    np.testing.assert_array_equal(flat2["w"], tree["w"].numpy())


def test_restore_missing_returns_none(tmp_path):
    st = CheckpointStore(str(tmp_path / "empty"))
    step, tree = st.restore()
    assert step is None and tree is None
    step, tree = st.restore(like={"w": torch.zeros(3)})
    assert step is None and tree is None


def test_large_tensor_chunking(tmp_path):
    st = CheckpointStore(str(tmp_path / "big"))
    big = torch.arange(600000, dtype=torch.float64)   # ~4.6 MB → >1 chunk
    st.save(1, {"big": big})
    _, got = st.restore()
    np.testing.assert_array_equal(got["big"], big.numpy())
    like = {"big": torch.zeros(600000, dtype=torch.float64)}
    st.restore(like=like)
    assert torch.equal(like["big"], big)


# -- what the port's store adds: bf16 leaves, dtypes, shape checks --

def test_bf16_leaf_is_stored_as_raw_bits(tmp_path):
    st = CheckpointStore(str(tmp_path / "bf16"))
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    st.save(0, {"m": x, "count": torch.tensor(7, dtype=torch.int32)})
    _, flat = st.restore()
    assert flat["m"].dtype == np.uint16 and flat["m"].shape == (3, 5)
    assert torch.equal(torch.from_numpy(flat["m"]).view(torch.bfloat16), x)
    assert flat["count"].dtype == np.int32 and int(flat["count"]) == 7
    like = {"m": torch.zeros(3, 5, dtype=torch.bfloat16),
            "count": torch.zeros((), dtype=torch.int32)}
    st.restore(like=like)
    assert torch.equal(like["m"], x) and int(like["count"]) == 7


def test_restore_casts_to_the_like_dtype(tmp_path):
    """As the JAX store's ``arr.astype(leaf.dtype)``: f32 into a bf16 leaf
    rounds to nearest even."""
    st = CheckpointStore(str(tmp_path / "cast"))
    x = torch.randn(64, generator=torch.Generator().manual_seed(1))
    st.save(0, {"x": x})
    like = {"x": torch.zeros(64, dtype=torch.bfloat16)}
    st.restore(like=like)
    assert torch.equal(like["x"], x.to(torch.bfloat16))


def test_restore_refuses_another_shape(tmp_path):
    st = CheckpointStore(str(tmp_path / "shape"))
    st.save(0, {"x": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="stored shape"):
        st.restore(like={"x": torch.zeros(3, 4)})
    with pytest.raises(KeyError, match="no checkpoint at step 9"):
        st.restore(step=9)


def test_recover_on_a_new_directory_raises(tmp_path):
    """Why the port's driver opens a directory with no store without
    ``recover``: there is no manifest to replay."""
    with pytest.raises(KeyError):
        CheckpointStore(str(tmp_path / "new"), recover=True)


@pytest.mark.parametrize("recoveries", [1, 2, 3])
def test_recovered_store_survives_another_restart(tmp_path, recoveries):
    root = str(tmp_path / "ckpt")
    st = CheckpointStore(root)
    for step in (2, 5):
        st.save(step, {"w": torch.arange(10, dtype=torch.float32) + step})
    for _ in range(recoveries):
        st = CheckpointStore(root, recover=True)
        assert st.steps() == [2, 5]
    step, flat = st.restore()
    assert step == 5
    np.testing.assert_array_equal(flat["w"], np.arange(10, dtype=np.float32)
                                  + 5)


# -- one directory, both packages --

def _jax_state(moments):
    """JAX olmo-1b SMOKE params from seed 0 and the AdamW state after one
    step with gradients from numpy seed 1, as numpy trees."""
    cfg = j_get_config("olmo-1b", smoke=True)
    params = j_get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)
    acfg = j_opt.AdamWConfig(lr=1e-3, moment_dtype=JDT[moments])
    params, opt = j_opt.apply_updates(params, grads,
                                      j_opt.init_state(params, acfg), acfg)
    return jax.tree.map(np.asarray, {"params": params, "opt": opt})


def _torch_state(moments):
    """The same trees in the port: params from the JAX init of seed 0
    through ``params_from_numpy``, one AdamW step with the same grads."""
    cfg = j_get_config("olmo-1b", smoke=True)
    init = jax.tree.map(np.asarray,
                        j_get_model(cfg).init(cfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(init, device="cpu")
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), init)
    acfg = AdamWConfig(lr=1e-3, moment_dtype=TDT[moments])
    params, opt = apply_updates(params, params_from_numpy(grads, "cpu"),
                                init_state(params, acfg), acfg)
    return {"params": params, "opt": opt}


def _torch_like(moments):
    cfg = j_get_config("olmo-1b", smoke=True)
    init = jax.tree.map(np.asarray,
                        j_get_model(cfg).init(cfg, jax.random.PRNGKey(2)))
    params = params_from_numpy(init, device="cpu")
    return {"params": params,
            "opt": init_state(params, AdamWConfig(moment_dtype=TDT[moments]))}


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, moments):
    root = str(tmp_path / "ckpt")
    want = _jax_state(moments)
    JCheckpointStore(root, JCheckpointConfig(keep_last=2)).save(
        1, want, extra={"loss": 0.5})
    st = CheckpointStore(root, CheckpointConfig(keep_last=2), recover=True)
    like = _torch_like(moments)
    step, got = st.restore(like=like)
    assert step == 1 and got is like
    assert got["opt"]["count"].dtype == torch.int32
    assert int(got["opt"]["count"]) == 1
    _assert_same_bits(got, want)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_port_checkpoint_restores_in_jax(tmp_path, moments):
    root = str(tmp_path / "ckpt")
    want = _torch_state(moments)
    CheckpointStore(root, CheckpointConfig(keep_last=2)).save(
        1, want, extra={"loss": 0.5})
    st = JCheckpointStore(root, JCheckpointConfig(keep_last=2), recover=True)
    like = jax.tree.map(jnp.zeros_like, _jax_state(moments))
    step, got = st.restore(like=like)
    assert step == 1
    got = jax.tree.map(np.asarray, got)
    assert got["opt"]["count"].dtype == np.int32
    _assert_same_bits(want, got)
    # both packages' trees from one seed hold the same names, shapes and
    # dtypes (their AdamW arithmetic is held to each other elsewhere)
    ref = _jax_state(moments)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), got) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref)


def test_jax_driver_store_without_recover_restores_nothing(tmp_path):
    """The reference's ``--resume`` opens its store without ``recover``,
    and such a store over an existing directory finds no checkpoint: the
    JAX driver's resume starts again from step 0."""
    root = str(tmp_path / "ckpt")
    st = JCheckpointStore(root, JCheckpointConfig(keep_last=2))
    tree = {"w": np.arange(10, dtype=np.float32)}
    for step in (2, 5):
        st.save(step, tree)
    assert JCheckpointStore(root, JCheckpointConfig(keep_last=2)).restore() \
        == (None, None)
    step, flat = JCheckpointStore(root, JCheckpointConfig(keep_last=2),
                                  recover=True).restore()
    assert step == 5
    np.testing.assert_array_equal(flat["w"], tree["w"])


def test_jax_store_recovered_twice_loses_the_wal(tmp_path):
    """The reference engine deletes the WAL files it replays at recovery
    and does not log their records again; a store recovered a second time
    before a flush finds nothing.  The port's store flushes on recovery
    (test_recovered_store_survives_another_restart)."""
    root = str(tmp_path / "ckpt")
    st = JCheckpointStore(root)
    for step in (2, 5):
        st.save(step, {"w": np.arange(10, dtype=np.float32)})
    assert JCheckpointStore(root, recover=True).steps() == [2, 5]
    assert JCheckpointStore(root, recover=True).steps() == []


# -- the engine copy --

def test_engine_copy_covers_the_stores_imports():
    """core/, store/, obs/ and bench/ hold the same files in both
    packages, so the byte-equality cases below cover the whole engine."""
    assert ENGINE == _engine_files(SRC / "repro")
    assert len(ENGINE) == 34


@pytest.mark.parametrize("rel", ENGINE)
def test_engine_copy_equals_its_source(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() == \
        (SRC / "repro" / rel).read_bytes()


def test_torch_ckpt_gc_example_prints_the_jax_example_lines():
    def run(script, *args):
        res = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                              *args], capture_output=True, text=True,
                             env={"PYTHONPATH": str(SRC),
                                  "PATH": "/usr/bin:/bin"}, timeout=300)
        assert res.returncode == 0, res.stderr
        return res.stdout.splitlines()
    got = run("torch_ckpt_gc.py", "--device", "cpu")
    assert got[-1] == \
        "restore(latest) verified; GC held disk near 2x model size"
    assert got == run("ckpt_gc.py")


def test_torch_train_lm_example_leaves_no_store_behind(tmp_path):
    """Without --ckpt-dir the example checkpoints into a new temporary
    directory and removes it, so a second run meets no old store."""
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "TMPDIR": str(tmp_path)}
    for _ in range(2):
        res = subprocess.run([sys.executable,
                              str(ROOT / "examples" / "torch_train_lm.py"),
                              "--steps", "1", "--device", "cpu"],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout.splitlines()[-1] == "training done"
        assert list(tmp_path.iterdir()) == []
