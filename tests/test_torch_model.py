"""The port's transformer (dense and MoE) against the JAX package, on the CPU.

Both packages get the same inputs (made with numpy) and the same weights
(JAX's init, carried over by ``params_from_numpy``).  On the CPU the port's
chunked attention runs the flash kernel's plain version
(``kernels/ref.py``), where JAX runs its jnp streaming softmax.

Tolerances: in float32 every product is taken in f32 on both sides and only
the order of the sums differs, so outputs agree to ~1e-6 relative; 2e-5
(1e-4 for logits, which pass through every layer and reach ~4) leaves a
margin of 4x or more.  In bfloat16 the two frameworks round at different
points (matmul outputs, the softmax weights, silu/gelu, the chunked path's
unnormalised p against the plain version's normalised weights), each
rounding off by up to 2^-8 relative, and the random weights make the
attention nearly one-hot, so a rounded score can move a whole row: bf16
results are held to 8% of the output's largest magnitude at the worst
element and 1% on average, which an error in the math (a wrong mask, RoPE
pairing or head grouping) exceeds many times over.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import modules as jm
from repro.train import data as j_data
from repro_torch.configs import get_config
from repro_torch.models import modules as tm
from repro_torch.models import transformer
from repro_torch.train import (build_decode_step, build_prefill_step,
                               synthetic_batch)
from repro_torch.weights import params_from_numpy

ARCHS = ["olmo-1b", "phi3-mini-3.8b", "starcoder2-3b", "phi3-medium-14b",
         "granite-moe-3b-a800m", "grok-1-314b"]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


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


def _cfgs(arch, dtype, **kw):
    """(JAX config, port config) at SMOKE size with the same overrides."""
    jc = dataclasses.replace(j_get_config(arch, smoke=True),
                             compute_dtype=JDT[dtype], **kw)
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype=TDT[dtype], **kw)
    return jc, tc


def _both(x, dtype):
    """The same numpy values as a JAX array and a torch tensor; bf16 is
    rounded from f32 to nearest even on both sides, so they are equal."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _params(jc, seed=0):
    jp = j_get_model(jc).init(jc, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step,b,s,cap", [(0, 2, 32, 0), (7, 3, 17, 100)])
def test_synthetic_batch_is_bit_exact(arch, step, b, s, cap):
    want = j_data.synthetic_batch(j_get_config(arch), step, b, s, cap)
    got = synthetic_batch(get_config(arch), step, b, s, cap)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, size=(2, 5, 64)).astype(np.float32)
    gamma = rng.normal(size=(64,)).astype(np.float32)
    xj, xt = _both(x, dtype)
    pairs = [
        (tm.rmsnorm(xt), jm.rmsnorm(xj)),
        (tm.rmsnorm(xt, torch.from_numpy(gamma)),
         jm.rmsnorm(xj, jnp.asarray(gamma))),
        (tm.layernorm_nonparametric(xt), jm.layernorm_nonparametric(xj)),
    ]
    for got, want in pairs:
        assert got.dtype == TDT[dtype]
        # both compute in f32 from the same inputs and round once at the end
        tol = 2e-5 if dtype == "f32" else 1e-2
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 9)).astype(np.int32)
    xj, xt = _both(x, dtype)
    # the frequency table, made on the tensor's device, is the same f32 table
    np.testing.assert_array_equal(tm.rope_freqs(16, theta).float().numpy(),
                                  jm.rope_freqs(16, theta).astype(np.float32))
    got = tm.apply_rope(xt, torch.from_numpy(pos), theta)
    want = jm.apply_rope(xj, jnp.asarray(pos), theta)
    assert got.dtype == TDT[dtype]
    # f32: cos/sin of angles up to 4096 rad differ in the last ulps between
    # the two libraries; bf16 outputs may then round one ulp apart.
    tol = 5e-4 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_rope_pairs_are_interleaved():
    # Position 1 rotates the pair (x0, x1) by 1 rad: an interleaved layout,
    # not rotate-half (which would pair x0 with x_{D/2}).
    x = torch.zeros(1, 2, 1, 8)
    x[0, 1, 0, 0] = 1.0
    y = tm.apply_rope(x, torch.tensor([[0, 1]]))
    want = torch.zeros(8)
    want[0], want[1] = np.cos(1.0), np.sin(1.0)
    torch.testing.assert_close(y[0, 1, 0], want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("branch", ["naive", "chunked", "decode"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gqa_attention_matches_jax(arch, branch, dtype):
    impl = "naive" if branch == "decode" else branch
    jc, tc = _cfgs(arch, dtype, attn_impl=impl, attn_chunk=8)
    p = jm.materialize(jm.attention_specs(jc), jax.random.PRNGKey(3), False)
    pt = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(4)
    b, s, hd = 2, 32, jc.head_dim
    if branch == "decode":
        x = rng.normal(size=(b, 1, jc.d_model)).astype(np.float32)
        lengths = np.array([5, 20], np.int32)
        kv = [rng.normal(size=(b, s, jc.kv_heads, hd)).astype(np.float32)
              for _ in range(2)]
        kv_pos = np.where(np.arange(s)[None] <= lengths[:, None],
                          np.arange(s)[None], -1).astype(np.int32)
        xj, xt = _both(x, dtype)
        (kj, kt), (vj, vt) = (_both(a, dtype) for a in kv)
        want, _ = jm.gqa_attention(p, xj, jnp.asarray(lengths[:, None]), jc,
                                   causal=False, kv_override=(kj, vj),
                                   kv_positions=jnp.asarray(kv_pos))
        got, _ = tm.gqa_attention(pt, xt, torch.from_numpy(lengths[:, None]),
                                  tc, causal=False, kv_override=(kt, vt),
                                  kv_positions=torch.from_numpy(kv_pos))
    else:
        x = rng.normal(size=(b, s, jc.d_model)).astype(np.float32)
        pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        xj, xt = _both(x, dtype)
        want, (wk, wv) = jm.gqa_attention(p, xj, jnp.asarray(pos), jc)
        got, (gk, gv) = tm.gqa_attention(pt, xt, torch.from_numpy(pos), tc)
        assert_close(gk, wk, dtype)
        assert_close(gv, wv, dtype)
    assert got.dtype == TDT[dtype]
    assert_close(got, want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match_jax(arch, impl, dtype):
    jc, tc = _cfgs(arch, dtype, attn_impl=impl, attn_chunk=8)
    jp, tp = _params(jc)
    batch = synthetic_batch(tc, 0, 2, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = transformer.forward(tp, tb, tc)
    assert logits.shape == (2, 32, tc.vocab) and logits.dtype == TDT[dtype]
    if tc.n_experts > 1 and impl == "chunked" and dtype == "bf16":
        # The port's chunked path on the CPU is K3's plain version, which
        # rounds as JAX's naive path does; JAX's jnp chunked path rounds
        # elsewhere (ROADMAP F9).  At the MoE SMOKE widths (granite's head
        # dim is 8) F7's nearly one-hot attention turns that into up to
        # 0.24 between JAX's own two bf16 paths, so the MoE archs are held
        # to JAX's naive path here.
        naive = dataclasses.replace(jc, attn_impl="naive")
        want = j_get_model(naive).forward(jp, jb, naive)
    else:
        want = j_get_model(jc).forward(jp, jb, jc)
    assert_close(logits, want, dtype, 1e-4)
    loss = float(transformer.loss_fn(tp, tb, tc))
    want = float(j_get_model(jc).loss_fn(jp, jb, jc))
    # f32: a mean of log-softmax terms, ~1e-6 relative; bf16: the logits'
    # rounding shifts the mean by well under 1%.
    assert loss == pytest.approx(want, rel=1e-5 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_matches_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(jc, seed=1)
    b, max_seq = 2, 16
    jcache = j_get_model(jc).init_cache(jc, b, max_seq)
    cache = transformer.init_cache(tc, b, max_seq, device="cpu")
    assert tuple(cache.shape) == jcache.shape
    assert cache.dtype == TDT[dtype] and not bool(cache.any())
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jc.vocab, size=(b, 3)).astype(np.int32)
    lengths = np.array([0, 4], np.int32)
    # three steps, so the cache each step reads holds earlier steps' rows
    for t in range(3):
        lg_j, jcache = j_get_model(jc).decode_step(
            jp, jcache, jnp.asarray(lengths + t), jnp.asarray(tokens[:, t:t + 1]),
            jc)
        lg_t, cache = transformer.decode_step(
            tp, cache, torch.from_numpy(lengths + t),
            torch.from_numpy(tokens[:, t:t + 1]), tc)
        assert lg_t.shape == (b, 1, tc.vocab)
        assert_close(lg_t, lg_j, dtype, 1e-4)
        assert_close(cache, jcache, dtype, 1e-4)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_prefill_decode_consistency_dense(impl):
    """Greedy decode over a cache must match teacher-forced forward
    (tests/test_models.py's check, run on the port)."""
    cfg = dataclasses.replace(get_config("phi3_mini_3_8b", smoke=True),
                              compute_dtype=torch.float32, attn_impl=impl)
    params = transformer.init(cfg, torch.Generator().manual_seed(2), "cpu")
    b, s = 1, 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))
    pos = torch.arange(s, dtype=torch.int32)[None].repeat(b, 1)
    full = transformer.forward(params, {"tokens": tokens, "positions": pos},
                               cfg)
    cache = transformer.init_cache(cfg, b, 16, device="cpu")
    outs = []
    for t in range(s):
        lengths = torch.full((b,), t, dtype=torch.int32)
        lg, cache = transformer.decode_step(params, cache, lengths,
                                            tokens[:, t:t + 1], cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-3b"])
def test_prefill_step_is_last_token_of_forward(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="chunked")
    params = transformer.init(cfg, torch.Generator().manual_seed(0), "cpu")
    step, (params_abs, batch_abs) = build_prefill_step(cfg, 2, 16, "cpu")
    batch = synthetic_batch(cfg, 0, 2, 16)
    batch.pop("targets")
    got = step(params, batch)
    full = transformer.forward(
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


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_inputs_match_jax(arch):
    from jax.sharding import AxisType

    from repro.train import step as j_step
    jc, tc = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    *_, want = j_step.build_prefill_step(jc, mesh, 2, 16)
    _, got = build_prefill_step(tc, 2, 16, "cpu")
    assert _abstract_like(dict(enumerate(got))) == \
        _abstract_like(dict(enumerate(want)))
    *_, want = j_step.build_decode_step(jc, mesh, 2, 64)
    serve_step, got = build_decode_step(tc, 2, 64, "cpu")
    assert _abstract_like(dict(enumerate(got))) == \
        _abstract_like(dict(enumerate(want)))
    # and the step runs on real inputs of those shapes
    params = transformer.init(tc, torch.Generator().manual_seed(0), "cpu")
    cache = transformer.init_cache(tc, 2, 64, device="cpu")
    logits, cache = serve_step(params, cache, np.array([3, 5], np.int32),
                               np.ones((2, 1), np.int32))
    assert logits.shape == (2, 1, tc.vocab)
    assert bool(torch.isfinite(logits).all())
    assert bool(cache[:, :, 0, 3].any()) and not bool(cache[:, :, 0, 4].any())


@pytest.mark.parametrize("change,match", [
    ({"rope": "mrope"}, "M-RoPE"),
    ({"frontend": "vision"}, "frontend"),
])
def test_unported_branches_raise(change, match):
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True), **change)
    params = transformer.init(get_config("olmo-1b", smoke=True),
                              torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 0, 1, 8).items()}
    if "tokens" not in batch:
        batch["tokens"] = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=match):
        transformer.forward(params, batch, cfg)
