"""The port's MoE FFN against the JAX package's ``moe_ffn``, on the CPU.

Inputs come from numpy seeds; weights from JAX's init, carried over by
``params_from_numpy``.  The JAX routing plan is computed here with the same
calls as ``src/repro/models/modules.py:300-316`` (``jax.lax.top_k``,
``jnp.argsort``, ``jnp.searchsorted``).

Tolerances.  The routing plan is integers and is held equal; the gates are
one f32 softmax on each side, held to 1e-6.  f32 outputs and gradients:
every product is taken in f32 on both sides and only the order of the sums
differs: measured ≤ 4.4e-7 of the largest magnitude, outputs and every
gradient (held to 1e-5).  bf16 outputs: the two frameworks round at
different places (the products, silu, the gates' cast; XLA on the CPU may
also skip intermediate bf16 roundings), each off by up to 2^-8 relative:
measured ≤ 0.65% of the largest magnitude at the worst element and ≤ 0.06%
on average, held to 5% and 0.5% (a token near a tie of its k-th and
(k+1)-th logits could take another expert on one side and move its row by
more; none does here).  ``pair_sum`` is held bit for bit to a sequential
bf16 sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.models import modules as jm
from repro_torch.configs import get_config
from repro_torch.models import modules as tm
from repro_torch.weights import params_from_numpy

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cfgs(arch, dtype="f32", **kw):
    jc = dataclasses.replace(j_get_config(arch, smoke=True),
                             compute_dtype=JDT[dtype], **kw)
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype=TDT[dtype], **kw)
    return jc, tc


def _jax_plan(logits, e, k, capacity_factor):
    """The reference's routing, line for line (modules.py:300-316)."""
    n = logits.shape[0]
    gates, idx = jax.lax.top_k(logits, k)
    gates = jax.nn.softmax(gates, axis=-1)
    cap = max(int(np.ceil(n * k / e * capacity_factor)), 8)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(e))
    rank = jnp.arange(n * k) - starts[sorted_e]
    keep = rank < cap
    slot = jnp.where(keep, sorted_e * cap + rank, e * cap)
    return {"gates": gates, "idx": idx, "order": order, "slot": slot,
            "tok": order // k, "keep": keep, "cap": cap}


# (N tokens, E, k, skew): integer-valued logits force ties; a skew adds a
# bias to the first experts so that pairs overflow their capacity.
@pytest.mark.parametrize("n,e,k,skew", [
    (64, 8, 4, 0.0), (64, 8, 4, 3.0),       # granite-moe SMOKE
    (32, 4, 2, 0.0), (32, 4, 2, 2.0),       # grok-1 SMOKE
    (3, 8, 4, 0.0),                         # the capacity's floor of 8
    (256, 40, 8, 0.0), (256, 40, 8, 4.0),   # granite-moe full width
])
def test_moe_route_matches_jax_with_ties(n, e, k, skew):
    rng = np.random.default_rng(n + e + k)
    logits = rng.integers(-2, 3, size=(n, e)).astype(np.float32)
    logits[:, :2] += skew
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True),
                              n_experts=e, top_k=k,
                              compute_dtype=torch.float32)
    got = tm.moe_route(torch.from_numpy(logits), cfg)
    want = _jax_plan(jnp.asarray(logits), e, k, cfg.capacity_factor)
    assert got["cap"] == want["cap"]
    for name in ["idx", "order", "slot", "tok", "keep"]:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_allclose(got["gates"].numpy(), np.asarray(want["gates"]),
                               rtol=1e-6, atol=1e-6)
    # ties did occur among each token's k+1 largest, and the skew dropped
    top = np.sort(logits, axis=1)[:, ::-1][:, :k + 1]
    assert (np.diff(top, axis=1) == 0).any()
    if skew:
        assert bool((~got["keep"]).any())


def _ffn_case(arch, dtype, skew, seed=0):
    jc, tc = _cfgs(arch, dtype)
    p = jm.materialize(jm.ffn_specs(jc), jax.random.PRNGKey(seed), False)
    p = jax.tree.map(np.asarray, p)
    # x has a mean of 1 in every feature, so adding skew / d_model to the
    # router's first column adds about ``skew`` to every token's logit of
    # expert 0 (half that to expert 1's): they overflow.  A skew of a few
    # units keeps the gates off saturation, where f32 softmax gradients
    # cancel (1 - g ~ eps) and both frameworks lose their last digits.
    p["router"] = p["router"].copy()
    p["router"][:, 0] += skew / jc.d_model
    p["router"][:, 1] += skew / 2 / jc.d_model
    x = np.random.default_rng(seed + 1).normal(
        1.0, 1.0, size=(2, 16, jc.d_model)).astype(np.float32)
    return jc, tc, p, x


def _dropped(tc, pt, x):
    xt = torch.from_numpy(x).reshape(-1, tc.d_model).to(tc.compute_dtype)
    logits = (xt @ pt["router"].to(tc.compute_dtype)).float()
    return int((~tm.moe_route(logits, tc)["keep"]).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_moe_ffn_matches_jax(arch, dtype, skew):
    jc, tc, p, x = _ffn_case(arch, dtype, skew)
    pt = params_from_numpy(p, device="cpu")
    if skew:
        assert _dropped(tc, pt, x) > 0
    want = np.asarray(jm.moe_ffn(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x, JDT[dtype]), jc)
                      .astype(jnp.float32))
    got = tm.moe_ffn(pt, torch.from_numpy(x).to(TDT[dtype]), tc)
    assert got.dtype == TDT[dtype] and got.shape == x.shape
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    if dtype == "f32":
        assert float(diff.max()) <= 1e-5 * scale
    else:
        assert float(diff.mean()) <= 0.005 * scale, float(diff.mean())
        assert float(diff.max()) <= 0.05 * scale, float(diff.max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_moe_ffn_grads_match_jax(arch, skew):
    """dx and each weight's gradient against jax.vjp of moe_ffn, in f32,
    with and without dropped pairs."""
    jc, tc, p, x = _ffn_case(arch, "f32", skew, seed=3)
    dy = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: jm.moe_ffn(p, x, jc),
                     jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(dy))
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(p, device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = tm.moe_ffn(leaves, xt, tc)
    got = torch.autograd.grad(y, [xt] + list(leaves.values()),
                              torch.from_numpy(dy))
    wants = [np.asarray(jx)] + [np.asarray(jp[k]) for k in leaves]
    for name, g, w in zip(["x"] + list(leaves), got, wants):
        scale = float(np.abs(w).max())
        assert scale > 0, name
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, name


def _sequential_bf16(terms):
    """Σ terms in the given order from zero, each add rounded to bf16."""
    acc = np.zeros(terms[0].shape, ml_dtypes.bfloat16)
    for t in terms:
        acc = (acc.astype(np.float32) + t.astype(np.float32)) \
            .astype(ml_dtypes.bfloat16)
    return acc.astype(np.float32)


def _bf16_plan(seed, n=48, e=8, k=4):
    """A routing plan with dropped pairs, its maps and rows in bf16."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, e)).astype(np.float32)
    logits[:, 0] += 1.5
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True),
                              n_experts=e, top_k=k)
    plan = tm.moe_route(torch.from_numpy(logits), cfg)
    assert bool((~plan["keep"]).any())
    return cfg, plan, tm._moe_maps(plan, e), rng


def test_pair_sum_is_a_sequential_bf16_sum_in_expert_order():
    """The combine adds each token's kept pairs' gated rows in ascending
    expert order, each add rounded to bf16: equal in every element to a
    sequential sum taken pair by pair from the plan."""
    cfg, plan, maps, rng = _bf16_plan(5)
    e, cap, d = cfg.n_experts, plan["cap"], 24
    out = torch.from_numpy(rng.normal(size=(e * cap, d)).astype(np.float32)
                           ).bfloat16()
    got = tm._Combine.apply(out, plan["gates"], plan["order"], maps)
    assert got.dtype == torch.bfloat16
    idx, gates = plan["idx"].numpy(), plan["gates"].float().numpy()
    pos = np.argsort(plan["order"].numpy())         # pair (t, j) -> position
    slot, keep = plan["slot"].numpy(), plan["keep"].numpy()
    rows = out.float().numpy()
    for t in range(idx.shape[0]):
        terms = []
        for j in np.argsort(idx[t]):                # ascending expert
            p = pos[t * cfg.top_k + j]
            term = np.zeros(d, np.float32)
            if keep[p]:
                term = (rows[slot[p]] * gates[t, j]).astype(
                    ml_dtypes.bfloat16).astype(np.float32)
            terms.append(term)
        np.testing.assert_array_equal(got[t].float().numpy(),
                                      _sequential_bf16(terms))


def test_dispatch_gradient_is_a_sequential_bf16_sum_in_expert_order():
    """The dispatch's backward gives each token the sum of its kept pairs'
    buffer-row gradients, in ascending expert order, each add rounded to
    bf16; a dropped pair adds nothing."""
    cfg, plan, maps, rng = _bf16_plan(6)
    n, k, d = plan["idx"].shape[0], cfg.top_k, 16
    xt = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                          ).bfloat16().requires_grad_()
    buf = tm._Dispatch.apply(xt, maps)
    dbuf = torch.from_numpy(rng.normal(size=tuple(buf.shape))
                            .astype(np.float32)).bfloat16()
    (got,) = torch.autograd.grad(buf, xt, dbuf)
    idx = plan["idx"].numpy()
    pos = np.argsort(plan["order"].numpy())
    slot, keep = plan["slot"].numpy(), plan["keep"].numpy()
    # every kept slot holds exactly its pair's token row
    for p in np.flatnonzero(keep):
        assert torch.equal(buf[slot[p]], xt[plan["tok"][p]].detach())
    assert int((buf.float().abs().sum(1) > 0).sum()) <= int(keep.sum())
    rows = dbuf.float().numpy()
    for t in range(n):
        terms = [rows[slot[pos[t * k + j]]] if keep[pos[t * k + j]]
                 else np.zeros(d, np.float32) for j in np.argsort(idx[t])]
        np.testing.assert_array_equal(got[t].float().numpy(),
                                      _sequential_bf16(terms))


class _Ops(TorchDispatchMode):
    """Records each aten op and whether an index_put accumulates."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        if "index_put" in name:
            acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            name += "(accumulate)" if acc else ""
        self.ops.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_path_adds_nothing_by_index(arch):
    """Forward and backward of the MoE FFN (with dropped pairs) run no
    op that adds into repeated indices (index_add, scatter_add,
    scatter_reduce, an accumulating index_put): on CUDA those add by
    atomics, in an order that changes from run to run.  The ops are the
    same on the card; only their kernels differ."""
    jc, tc, p, x = _ffn_case(arch, "bf16", 3.0)
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(p, device="cpu").items()}
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    with _Ops() as rec:
        y = tm.moe_ffn(leaves, xt, tc)
        torch.autograd.grad(y, [xt] + list(leaves.values()),
                            torch.ones_like(y))
    assert "bmm.default" in rec.ops and "sort.stable" in rec.ops
    banned = [op for op in rec.ops
              if op.startswith(("index_add", "scatter_add", "scatter_reduce",
                                "embedding_dense_backward"))
              or op.endswith("(accumulate)")]
    assert banned == []


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_repeats_bit_for_bit(arch):
    jc, tc, p, x = _ffn_case(arch, "bf16", 3.0)
    runs = []
    for _ in range(2):
        leaves = {k: v.requires_grad_() for k, v in
                  params_from_numpy(p, device="cpu").items()}
        xt = torch.from_numpy(x).bfloat16().requires_grad_()
        y = tm.moe_ffn(leaves, xt, tc)
        runs.append([y] + list(torch.autograd.grad(
            y, [xt] + list(leaves.values()), torch.ones_like(y))))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_moe_routes_topk_and_preserves_scale():
    """tests/test_models.py's check, run on the port (grok-1 SMOKE, bf16,
    the port's own init)."""
    cfg = get_config("grok_1_314b", smoke=True)
    params = tm.materialize(tm.ffn_specs(cfg),
                            torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(cfg.compute_dtype)
    y = tm.moe_ffn(params, x, cfg)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    assert float(y.float().abs().sum()) > 0


def test_ffn_specs_match_jax():
    """Names, shapes and logical axes of the MoE branch (modules.py:254-264);
    materialize draws the expert weights with std 1/sqrt(E), fan-in from
    axis 0 (ROADMAP F7)."""
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        want = jm.ffn_specs(jc)
        got = tm.ffn_specs(tc)
        assert sorted(got) == sorted(want) == ["router", "wg", "wi", "wo"]
        for name in want:
            assert got[name].shape == want[name].shape, name
            assert got[name].axes == want[name].axes, name
    cfg = get_config("granite-moe-3b-a800m")
    spec = {"wi": tm.ffn_specs(cfg)["wi"]}
    wi = tm.materialize(spec, torch.Generator().manual_seed(0),
                        device="cpu")["wi"]
    assert abs(float(wi.std()) * np.sqrt(cfg.n_experts) - 1) < 0.01
