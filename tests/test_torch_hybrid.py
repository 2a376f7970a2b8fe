"""The port's hybrid model (jamba-v0.1-52b) against the JAX package, on the
CPU.

Both packages get the same inputs (made with numpy) and the same weights
(JAX's ``hybrid.init``, carried over by ``params_from_numpy``).  On the CPU
the port's Mamba positions run the SSD kernel's plain version and its
chunked attention K3's plain version; JAX runs its jnp code.  SMOKE has 8
layers, one super-block; the cases with ``n_layers=16`` take two blocks,
so that stacking and unstacking across blocks is held too.

Tolerances.  f32: only the order of the sums differs, so 2e-5 (1e-4 for
logits and caches, which pass through every position), of each element
and of the largest magnitude where that exceeds 1: at one or two blocks
every stacked weight has std 1 or 1/sqrt(2) (ROADMAP F7: fan-in from the
block axis), and the SSM state reaches ~600.  Gradients: ‖Δg‖/‖g‖ ≤ 2e-3
per leaf, where the dense and MoE models hold 2e-4; F7's large
activations amplify the rounding of the f32 sums, and the measured
distance is 1e-5 to 4.2e-4 at one block and up to 6.0e-4 at two (the
router of position 1), spread evenly over the leaves; a wrong gradient is
off by its own size.  bf16: under F7's large activations a rounded router
logit sends a token to another expert, so JAX's own bf16 logits lie up to
~0.35 from its f32 logits (scale ~0.72), and two bf16 computations that
round at different points can lie on either side of the f32 one (the
port's and JAX's bf16 decode logits lie 0.069 and 0.048 from JAX's f32
ones, 0.107 from each other).  So a bf16 result of the port is held to
JAX's f32 one, at the worst element within the larger of 8% of the
largest magnitude and twice JAX's own bf16 distance from it, on average
within the larger of 1% and twice JAX's mean distance, both measured in
the same test: the port's bf16 rounding may cost as much as the
reference's, with a margin of 2x.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.models import hybrid as jhybrid
from repro.models import modules as jm
from repro.train import step as j_step
from repro_torch.configs import get_config
from repro_torch.models import get_model, hybrid
from repro_torch.models.modules import ParamSpec
from repro_torch.train import (build_decode_step, build_prefill_step,
                               build_train_step, synthetic_batch)
from repro_torch.train.optimizer import tree_leaves, tree_unflatten
from repro_torch.weights import params_from_numpy

ARCH = "jamba-v0.1-52b"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
BLOCKS = [pytest.param(8, id="1block"), pytest.param(16, id="2blocks")]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, dtype, tol=2e-5, want32=None):
    """f32: ``tol`` of each element and of max(1, the largest magnitude).
    bf16: ``got`` against ``want32``, JAX's f32 result, within the larger
    of 8% of the largest magnitude and twice the distance of ``want``
    (JAX's bf16 result) from it at the worst element, of 1% and twice
    that distance on average."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=tol * max(1.0, scale),
                                   rtol=tol)
        return
    want32 = _np(want32)
    diff, ref = np.abs(got - want32), np.abs(want - want32)
    scale = float(np.abs(want32).max())
    assert float(diff.max()) <= max(0.08 * scale, 2 * float(ref.max())), \
        (float(diff.max()), scale, float(ref.max()))
    assert float(diff.mean()) <= max(0.01 * scale,
                                     2 * float(ref.mean())), \
        (float(diff.mean()), scale, float(ref.mean()))


def _cfgs(dtype, **kw):
    jc = dataclasses.replace(j_get_config(ARCH, smoke=True),
                             compute_dtype=JDT[dtype], **kw)
    tc = dataclasses.replace(get_config(ARCH, smoke=True),
                             compute_dtype=TDT[dtype], **kw)
    return jc, tc


def _params(jc, seed=0):
    jp = jhybrid.init(jc, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("n_layers", [8, 16, 32])
def test_roles_and_spec_tree_match_jax(n_layers):
    jc = dataclasses.replace(j_get_config(ARCH), n_layers=n_layers)
    tc = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
    roles = hybrid._position_roles(tc)
    assert roles == jhybrid._position_roles(jc)
    # attention at 4, MoE on the odd positions: the attention position
    # has a dense FFN
    assert [i for i, (m, _) in enumerate(roles) if m == "attn"] == [4]
    assert [i for i, (_, f) in enumerate(roles) if f == "moe"] == [1, 3, 5, 7]
    want = _flat(jhybrid.specs(jc))
    got = _flat(hybrid.specs(tc))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, ParamSpec), name
        assert (g.shape, g.axes, g.scale) == (w.shape, w.axes, w.scale), name
    assert got["blocks/pos0/ffn/wi"].shape[0] == n_layers // 8
    assert get_model(tc) is hybrid


@pytest.mark.parametrize("n_layers", BLOCKS)
@pytest.mark.parametrize("dtype,impl", [("f32", "naive"), ("f32", "chunked"),
                                        ("bf16", "naive")])
def test_forward_and_loss_match_jax(dtype, impl, n_layers):
    jc, tc = _cfgs(dtype, attn_impl=impl, n_layers=n_layers)
    jp, tp = _params(jc)
    batch = synthetic_batch(tc, 0, 2, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = hybrid.forward(tp, tb, tc)
    assert logits.shape == (2, 32, tc.vocab) and logits.dtype == TDT[dtype]
    want = jhybrid.forward(jp, jb, jc)
    j32 = dataclasses.replace(jc, compute_dtype=jnp.float32)
    assert_close(logits, want, dtype, 1e-4,
                 jhybrid.forward(jp, jb, j32) if dtype == "bf16" else None)
    loss = float(hybrid.loss_fn(tp, tb, tc))
    want = float(jhybrid.loss_fn(jp, jb, jc))
    # f32: a mean of log-softmax terms, ~1e-6 relative; bf16: the logits'
    # rounding shifts the mean by well under 1%.
    assert loss == pytest.approx(want, rel=1e-5 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("n_layers", BLOCKS)
def test_grads_match_jax(n_layers):
    """Loss and each leaf's gradient against jax.value_and_grad in f32, at
    ‖Δg‖/‖g‖ ≤ 2e-3 (the module docstring says why not 2e-4)."""
    jc, tc = _cfgs("f32", n_layers=n_layers)
    jp, tp = _params(jc, seed=1)
    batch = synthetic_batch(tc, 0, 2, 32)
    jloss, jg = jax.value_and_grad(jhybrid.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss = hybrid.loss_fn(tree_unflatten(tp, leaves),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          tc)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = {k: _np(v) for k, v in _flat(tree_unflatten(tp, grads)).items()}
    want = {k: _np(v) for k, v in _flat(jax.tree.map(np.asarray, jg)).items()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        norm = float(np.linalg.norm(w))
        assert norm > 0, name
        assert float(np.linalg.norm(got[name] - w)) <= 2e-3 * norm, name


def test_remat_policies_give_the_same_values_and_only_full_checkpoints(
        monkeypatch):
    """"full" checkpoints each block once (one call a block), "none" and
    "dots_with_no_batch_dims" run plain, as the reference does; on the CPU
    the recompute is the same arithmetic, so loss and gradients are equal
    to the last bit."""
    calls = []
    real = hybrid.checkpoint

    def counting(*args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*args, **kw)

    monkeypatch.setattr(hybrid, "checkpoint", counting)
    _, tc = _cfgs("f32", n_layers=16)
    params = hybrid.init(tc, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(tc, 0, 2, 32).items()}
    out = {}
    for remat in ["none", "full", "dots_with_no_batch_dims"]:
        cfg = dataclasses.replace(tc, remat=remat)
        calls.clear()
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = hybrid.loss_fn(tree_unflatten(params, leaves), batch, cfg)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
        assert calls == ([False, False] if remat == "full" else []), remat
    with torch.no_grad():      # no grad: the loop runs plain under "full"
        calls.clear()
        hybrid.forward(params, batch, dataclasses.replace(tc, remat="full"))
        assert calls == []
    loss0, g0 = out["none"]
    for remat in ["full", "dots_with_no_batch_dims"]:
        loss, g = out[remat]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), remat


@pytest.mark.parametrize("n_layers", BLOCKS)
def test_init_cache_matches_jax(n_layers):
    for dtype in ["f32", "bf16"]:
        jc, tc = _cfgs(dtype, n_layers=n_layers)
        want = jhybrid.init_cache(jc, 3, 20)
        got = hybrid.init_cache(tc, 3, 20, device="cpu")
        assert sorted(got) == sorted(want) == ["conv", "kv", "ssm"]
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert not bool(got[k].any())
        assert got["kv"].dtype == got["conv"].dtype == TDT[dtype]
        assert got["ssm"].dtype == torch.float32
    # kv_cache_dtype is not read here, as in the reference
    tc = dataclasses.replace(tc, kv_cache_dtype=torch.float8_e4m3fn)
    assert hybrid.init_cache(tc, 1, 4, device="cpu")["kv"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("n_layers", BLOCKS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_matches_jax_in_place(dtype, n_layers):
    """Three decode steps from lengths (0, 4): logits and all three caches
    against JAX's after every step (in bf16, against a JAX f32 decode
    beside it); each cache updated in place."""
    jc, tc = _cfgs(dtype, n_layers=n_layers)
    jp, tp = _params(jc, seed=1)
    j32 = dataclasses.replace(jc, compute_dtype=jnp.float32)
    b, max_seq = 2, 16
    jcache = jhybrid.init_cache(jc, b, max_seq)
    jcache32 = jhybrid.init_cache(j32, b, max_seq)
    cache = hybrid.init_cache(tc, b, max_seq, device="cpu")
    storage = dict(cache)
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab, size=(b, 3)).astype(np.int32)
    lengths = np.array([0, 4], np.int32)

    for t in range(3):
        args = (jnp.asarray(lengths + t), jnp.asarray(tokens[:, t:t + 1]))
        lg_j, jcache = jhybrid.decode_step(jp, jcache, *args, jc)
        lg_32, jcache32 = jhybrid.decode_step(jp, jcache32, *args, j32)
        lg_t, cache = hybrid.decode_step(
            tp, cache, torch.from_numpy(lengths + t),
            torch.from_numpy(tokens[:, t:t + 1]), tc)
        assert lg_t.shape == (b, 1, tc.vocab)
        assert_close(lg_t, lg_j, dtype, 1e-4, lg_32)
        for k in ("kv", "conv", "ssm"):
            assert_close(cache[k], jcache[k], dtype, 1e-4, jcache32[k])
    assert all(cache[k] is storage[k] for k in storage)
    assert bool(cache["ssm"].any()) and bool(cache["kv"][:, :, 1, 6].any())
    assert not bool(cache["kv"][:, :, 1, 7:].any())


def test_decode_matches_forward_across_chunks():
    """Token-by-token decode against the teacher-forced forward over three
    SSD chunks (SMOKE's chunk is 16), in f32 at 2e-3 of the logits' largest
    magnitude plus 2e-3 of each (tests/test_models.py's decode check).  The
    forward takes capacity_factor E/k, so that it drops no pair (F13)."""
    cfg = get_config(ARCH, smoke=True)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    params = hybrid.init(cfg, torch.Generator().manual_seed(2), "cpu")
    b, s = 2, 48
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 3, b, s).items()}
    full = hybrid.forward(params, batch, cfg)
    cache = hybrid.init_cache(cfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = hybrid.decode_step(
            params, cache, torch.full((b,), t, dtype=torch.int32),
            batch["tokens"][:, t:t + 1], cfg)
        outs.append(lg[:, 0])
    got, want = _np(torch.stack(outs, 1)), _np(full)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-3)


def test_prefill_step_is_last_token_of_forward():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              attn_impl="chunked")
    params = hybrid.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step, _ = build_prefill_step(cfg, 2, 32, "cpu")
    batch = synthetic_batch(cfg, 0, 2, 32)
    batch.pop("targets")
    got = step(params, batch)
    full = hybrid.forward(
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
    jc, tc = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for j_build, build, args in [
            (j_step.build_prefill_step, build_prefill_step, (2, 32)),
            (j_step.build_decode_step, build_decode_step, (2, 64)),
            (j_step.build_train_step, build_train_step, (4, 16))]:
        *_, want = j_build(jc, mesh, *args)
        _, got = build(tc, *args, device="cpu")
        assert _abstract_like(dict(enumerate(got))) == \
            _abstract_like(dict(enumerate(want))), build.__name__
    # and the decode step runs on real inputs of those shapes
    serve_step, _ = build_decode_step(tc, 2, 64, "cpu")
    params = hybrid.init(tc, torch.Generator().manual_seed(0), "cpu")
    cache = hybrid.init_cache(tc, 2, 64, device="cpu")
    logits, cache = serve_step(params, cache, np.array([3, 5], np.int32),
                               np.ones((2, 1), np.int32))
    assert logits.shape == (2, 1, tc.vocab)
    assert bool(torch.isfinite(logits).all())
    assert bool(cache["kv"][:, :, 0, 3].any())
    assert not bool(cache["kv"][:, :, 0, 4].any())


def test_jamba_uses_both_ffn_kinds_and_the_f7_init():
    """The MoE and dense positions hold the shapes the reference gives
    them, and a one-block init draws the stacked weights at std 1 (F7:
    fan-in from the block axis of length 1)."""
    jc = j_get_config(ARCH, smoke=True)
    specs = hybrid.specs(get_config(ARCH, smoke=True))["blocks"]
    assert specs["pos1"]["ffn"]["wi"].shape == (1, jc.n_experts, jc.d_model,
                                               jc.d_ff)
    assert "router" in specs["pos1"]["ffn"]
    assert specs["pos4"]["ffn"]["wi"].shape == (1, jc.d_model, jc.d_ff)
    assert "attn" in specs["pos4"] and "mamba" in specs["pos0"]
    jp = jm.materialize(jhybrid.specs(jc), jax.random.PRNGKey(0), False)
    w = np.asarray(jp["blocks"]["pos0"]["mamba"]["w_in"])
    assert 0.9 < float(w.std()) < 1.1
