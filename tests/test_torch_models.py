"""tests/test_models.py's per-architecture smoke tests, run on the port, for
every arch of the JAX package: one forward and train step at SMOKE size on
the CPU (shapes and finiteness), decode for the decoder archs; and M-RoPE
against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import modules as jm
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models import modules as tm
from repro_torch.train import (AdamWConfig, apply_updates, init_state,
                               synthetic_batch)
from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def _batch(cfg, b=2, s=32):
    return {k: torch.from_numpy(v)
            for k, v in synthetic_batch(cfg, 0, b, s).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    with torch.no_grad():
        logits = model.forward(params, batch, cfg)
    assert logits.shape == (2, 32, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = model.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert bool(torch.isfinite(loss))
    gn = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(gn) and gn > 0
    before = [p.clone() for p in tree_leaves(params)]
    opt = init_state(params, AdamWConfig())
    new_params, _ = apply_updates(params, tree_unflatten(params, grads), opt,
                                  AdamWConfig())
    # a step actually changes the params
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(tree_leaves(new_params), before))
    assert delta > 0


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "hubert_xlarge"])
def test_decode_step(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(1), "cpu")
    b = 2
    cache = (model.init_cache(cfg, b, device="cpu") if cfg.family == "ssm"
             else model.init_cache(cfg, b, 64, device="cpu"))
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    with torch.no_grad():
        logits, _ = model.decode_step(
            params, cache, lengths, torch.ones((b, 1), dtype=torch.int32),
            cfg)
    assert logits.shape == (b, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def _streams(s):
    """Three position streams that differ: (t, 2t, 3t)."""
    t = np.arange(s)
    return np.stack([t, 2 * t, 3 * t], axis=-1)[None].astype(np.int32)


def test_mrope_sections_differ_from_rope():
    x = torch.ones((1, 4, 2, 24))
    pos3 = torch.from_numpy(_streams(4))
    out = tm.apply_mrope(x, pos3, sections=(4, 4, 4))
    base = tm.apply_rope(x, pos3[..., 0])
    assert out.shape == x.shape
    assert not torch.allclose(out, base)
    # one stream repeated three times is RoPE at theta 1e6
    same = tm.apply_mrope(x, pos3[..., :1].repeat(1, 1, 3), sections=(4, 4, 4))
    torch.testing.assert_close(same, tm.apply_rope(x, pos3[..., 0], 1e6))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sections,d", [((4, 4, 4), 24), ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(dtype, sections, d):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 3, d)).astype(np.float32)
    pos3 = _streams(9).repeat(2, axis=0) + \
        rng.integers(0, 2048, size=(2, 1, 3)).astype(np.int32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = jm.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos3), sections)
    got = tm.apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos3),
                         sections)
    assert got.dtype == tdt and got.shape == x.shape
    # as apply_rope's test: cos/sin of angles up to ~8000 rad differ in the
    # last ulps between the two libraries; bf16 may then round one ulp apart
    tol = 5e-4 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    with pytest.raises(ValueError, match="sections"):
        tm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), (4, 4, 5))
