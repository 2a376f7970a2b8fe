"""The port's Mamba-2 model (mamba2-370m) against the JAX package, on the CPU.

Both packages get the same inputs (made with numpy) and the same weights
(JAX's ``ssm.init``, carried over by ``params_from_numpy``).  On the CPU the
port's ``ssd_layer`` runs the SSD kernel's plain version
(``kernels.ref.ssd_chunked_ref``), where JAX runs its jnp ``ssd_chunked``.

Tolerances, as tests/test_torch_model.py states them: in float32 only the
order of the sums differs, so 2e-5 (1e-4 for logits, which pass through
every layer); in bfloat16 the two frameworks round at different points, so
results are held to 8% of the output's largest magnitude at the worst
element and 1% on average.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import get_model, ssm
from repro_torch.train import (build_decode_step, build_prefill_step,
                               synthetic_batch)
from repro_torch.weights import params_from_numpy

ARCH = "mamba2-370m"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
DTYPES = ["f32", "bf16"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, dtype, tol=2e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    diff = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert float(diff.max()) <= 0.08 * scale, (float(diff.max()), scale)
    assert float(diff.mean()) <= 0.01 * scale, (float(diff.mean()), scale)


def _cfgs(dtype, **kw):
    jc = dataclasses.replace(j_get_config(ARCH, smoke=True),
                             compute_dtype=JDT[dtype], **kw)
    tc = dataclasses.replace(get_config(ARCH, smoke=True),
                             compute_dtype=TDT[dtype], **kw)
    return jc, tc


def _both(x, dtype):
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _params(jc, seed=0):
    jp = jssm.init(jc, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda w: w[i], jp["layers"]),
            {k: v[i] for k, v in tp["layers"].items()})


def test_registry_and_one_copy_of_the_chunked_scan():
    assert get_model(get_config(ARCH)) is ssm
    assert ssm.ssd_chunked is ref.ssd_chunked_ref
    assert ssm.D_CONV == jssm.D_CONV


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.normal(size=(2, 11, 40)).astype(np.float32), dtype)
    wj, wt = _both(rng.normal(size=(4, 40)).astype(np.float32), dtype)
    got = ssm._causal_conv(xt, wt)
    assert got.dtype == TDT[dtype]
    assert_close(got, jssm._causal_conv(xj, wj), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_layer_matches_jax(dtype, with_state):
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc)
    jl, tl = _layer(jp, tp, 1)
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.normal(size=(2, 48, jc.d_model)).astype(np.float32),
                   dtype)
    init = None
    if with_state:
        init = rng.normal(size=(2, jc.ssm_heads, jc.ssm_headdim,
                                jc.ssm_state)).astype(np.float32)
    want, wst = jssm.ssd_layer(jl, xj, jc, None if init is None
                               else jnp.asarray(init), return_state=True)
    got, gst = ssm.ssd_layer(tl, xt, tc, None if init is None
                             else torch.from_numpy(init), return_state=True)
    assert got.dtype == TDT[dtype] and gst.dtype == torch.float32
    assert_close(got, want, dtype)
    assert_close(gst, wst, dtype)
    assert torch.equal(ssm.ssd_layer(tl, xt, tc, None if init is None
                                     else torch.from_numpy(init)), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step_matches_jax(dtype):
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc, seed=2)
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(2)
    conv_dim = jc.d_inner + 2 * jc.ssm_state
    xj, xt = _both(rng.normal(size=(2, 1, jc.d_model)).astype(np.float32),
                   dtype)
    cj, ct = _both(rng.normal(size=(2, 3, conv_dim)).astype(np.float32),
                   dtype)
    state = rng.normal(size=(2, jc.ssm_heads, jc.ssm_headdim,
                             jc.ssm_state)).astype(np.float32)
    want = jssm.ssd_decode_step(jl, xj, cj, jnp.asarray(state), jc)
    got = ssm.ssd_decode_step(tl, xt, ct, torch.from_numpy(state), tc)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)
    assert got[1].dtype == TDT[dtype] and got[2].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_loss_match_jax(dtype):
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc)
    batch = synthetic_batch(tc, 0, 2, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = ssm.forward(tp, tb, tc)
    assert logits.shape == (2, 64, tc.vocab) and logits.dtype == TDT[dtype]
    assert_close(logits, jssm.forward(jp, jb, jc), dtype, 1e-4)
    loss = float(ssm.loss_fn(tp, tb, tc))
    want = float(jssm.loss_fn(jp, jb, jc))
    # f32: a mean of log-softmax terms, ~1e-6 relative; bf16: the logits'
    # rounding shifts the mean by well under 1%.
    assert loss == pytest.approx(want, rel=1e-5 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_jax_in_place(dtype):
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc, seed=1)
    b = 2
    jcache = jssm.init_cache(jc, b)
    cache = ssm.init_cache(tc, b, device="cpu")
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert not bool(cache[k].any())
    assert cache["conv"].dtype == TDT[dtype]
    assert cache["ssm"].dtype == torch.float32
    conv, state = cache["conv"], cache["ssm"]
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab, size=(b, 3)).astype(np.int32)
    lengths = np.array([0, 4], np.int32)
    # three steps, so each step reads the state the earlier ones left
    for t in range(3):
        lg_j, jcache = jssm.decode_step(jp, jcache, jnp.asarray(lengths + t),
                                        jnp.asarray(tokens[:, t:t + 1]), jc)
        lg_t, cache = ssm.decode_step(tp, cache, torch.from_numpy(lengths + t),
                                      torch.from_numpy(tokens[:, t:t + 1]),
                                      tc)
        assert lg_t.shape == (b, 1, tc.vocab)
        assert_close(lg_t, lg_j, dtype, 1e-4)
        assert_close(cache["conv"], jcache["conv"], dtype, 1e-4)
        assert_close(cache["ssm"], jcache["ssm"], dtype, 1e-4)
    # updated in place: the same storage, now written
    assert cache["conv"] is conv and cache["ssm"] is state
    assert bool(state.any())


def test_decode_matches_forward_across_chunks():
    """Token-by-token decode against the teacher-forced forward, over three
    SSD chunks (SMOKE's chunk is 16), in f32 at 2e-3 (tests/test_models.py's
    decode check)."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype=torch.float32)
    params = ssm.init(cfg, torch.Generator().manual_seed(2), "cpu")
    b, s = 2, 48
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))
    full = ssm.forward(params, {"tokens": tokens}, cfg)
    cache = ssm.init_cache(cfg, b, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = ssm.decode_step(params, cache, None, tokens[:, t:t + 1],
                                    cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               atol=2e-3, rtol=2e-3)


def test_forward_state_continues_in_decode():
    # The final state ssd_layer returns is the state decode carries on
    # from: a prefill of 32 tokens' state equals 32 decode steps' state.
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype=torch.float32, n_layers=1)
    params = ssm.init(cfg, torch.Generator().manual_seed(4), "cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 32, cfg.d_model)).astype(np.float32))
    _, state = ssm.ssd_layer(lp, x, cfg, return_state=True)
    cache = ssm.init_cache(cfg, 1, device="cpu")
    conv, st = cache["conv"][0], cache["ssm"][0]
    for t in range(32):
        _, conv, st = ssm.ssd_decode_step(lp, x[:, t:t + 1], conv, st, cfg)
    # f32, sums in different orders; the state's entries span 1e-1 to
    # ~6e3, so the absolute part is scaled to its largest magnitude.
    scale = float(st.abs().max())
    np.testing.assert_allclose(_np(state), _np(st), atol=2e-5 * scale,
                               rtol=2e-5)


def test_prefill_step_is_last_token_of_forward():
    cfg = get_config(ARCH, smoke=True)
    params = ssm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step, _ = build_prefill_step(cfg, 2, 32, "cpu")
    batch = synthetic_batch(cfg, 0, 2, 32)
    batch.pop("targets")
    got = step(params, batch)
    full = ssm.forward(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert got.shape == (2, cfg.vocab)
    assert torch.equal(got, full[:, -1, :])


def _abstract_like(tree):
    if isinstance(tree, dict):
        return {k: _abstract_like(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), str(tree.dtype)


def test_step_builders_inputs_match_jax():
    from jax.sharding import AxisType

    from repro.train import step as j_step
    jc, tc = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    *_, want = j_step.build_prefill_step(jc, mesh, 2, 32)
    _, got = build_prefill_step(tc, 2, 32, "cpu")
    assert _abstract_like(dict(enumerate(got))) == \
        _abstract_like(dict(enumerate(want)))
    *_, want = j_step.build_decode_step(jc, mesh, 2, 64)
    serve_step, got = build_decode_step(tc, 2, 64, "cpu")
    assert _abstract_like(dict(enumerate(got))) == \
        _abstract_like(dict(enumerate(want)))
    # and the step runs on real inputs of those shapes, writing the state
    params = ssm.init(tc, torch.Generator().manual_seed(0), "cpu")
    cache = ssm.init_cache(tc, 2, device="cpu")
    logits, cache = serve_step(params, cache, np.array([3, 5], np.int32),
                               np.ones((2, 1), np.int32))
    assert logits.shape == (2, 1, tc.vocab)
    assert bool(torch.isfinite(logits).all())
    assert bool(cache["ssm"].any()) and bool(cache["conv"][:, :, -1].any())
