"""The dry-run's flop rules (``launch.dryrun._RULES``, ``xla_flops``)
against XLA's cost analysis, on the CPU.

Each rule is held against ``jax.jit(f).lower(*xs).compile()
.cost_analysis()`` of its jnp counterpart on the same inputs: the aten
op runs on CPU tensors under the dry-run's counter (``_MetaCounter``),
and its flops and transcendentals must equal XLA's exactly for a
pointwise op, a cast, a transcendental and a backward op (the jnp
expression of the op's own formula); for a reduction (and softmax, which
holds two) they must lie within the spread XLA's CPU reduction counts
show: XLA counts n − 1 adds for a sum of n on long rows, and pads short
rows (x.sum(-1) of a (10, 100) array: 1270, where n − 1 gives 990), so
the rule lies between 0.75 and 1.01 of XLA's.  A sum into rows
(``scatter_add``) counts its adds, XLA's count less its 3 flops of index
arithmetic an index.  Then one olmo-1b SMOKE layer's f32 forward: the
port's ``_layer`` counted on meta tensors within 5% of XLA's flops for
the JAX ``_layer``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import transformer

N = 1000


def _xla(f, *xs):
    cost = jax.jit(f).lower(*xs).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return (float(cost.get("flops", 0.0)),
            float(cost.get("transcendentals", 0.0)))


def _port(f, *xs):
    counter = dryrun._MetaCounter()
    with counter:
        f(*xs)
    return float(counter.flops), float(counter.transcendentals)


def _inputs(shapes, dtypes=None, seed=0):
    rng = np.random.default_rng(seed)
    dtypes = dtypes or ["f32"] * len(shapes)
    out = []
    for shape, dt in zip(shapes, dtypes):
        x = rng.uniform(0.1, 1.0, size=shape).astype(np.float32)
        if dt == "i32":
            x = (x * 100).astype(np.int32)
        elif dt == "bool":
            x = x > 0.5
        out.append(x)
    return out


def _to_torch(x, dt):
    t = torch.from_numpy(np.asarray(x))
    return t.to(torch.bfloat16) if dt == "bf16" else t


def _to_jnp(x, dt):
    return jnp.asarray(x, jnp.bfloat16 if dt == "bf16" else None)


def _silu_bwd(g, x):
    s = jax.nn.sigmoid(x)
    return g * (s * (1 + x * (1 - s)))


def _gelu_bwd(g, x):
    # torch's formula for gelu_backward(approximate="tanh")
    kb, kk = math.sqrt(2) * (2 / math.sqrt(math.pi)) * 0.5, 0.044715
    xs = x * x
    t = jnp.tanh(kb * (x + kk * xs * x))
    left = 0.5 * x
    return g * (0.5 * (1 + t) + left * (1 - t * t) * (kb * (1 + 3 * kk * xs)))


def _softplus_bwd(g, x):
    z = jnp.exp(x)
    return jnp.where(x > 20, g, g * z / (z + 1))


V, G = (N,), (N,)
# rule: (torch fn, jnp fn, input shapes, input dtypes)
POINTWISE = {
    "add": (torch.add, jnp.add, (V, V)),
    "sub": (torch.sub, jnp.subtract, (V, V)),
    "rsub": (lambda x: 1 - x, lambda x: 1 - x, (V,)),
    "mul": (torch.mul, jnp.multiply, (V, V)),
    "div": (torch.div, jnp.divide, (V, V)),
    "neg": (torch.neg, jnp.negative, (V,)),
    "abs": (torch.abs, jnp.abs, (V,)),
    "maximum": (torch.maximum, jnp.maximum, (V, V)),
    "minimum": (torch.minimum, jnp.minimum, (V, V)),
    "reciprocal": (torch.reciprocal, lambda x: 1 / x, (V,)),
    "eq": (torch.eq, jnp.equal, (V, V)),
    "ne": (torch.ne, jnp.not_equal, (V, V)),
    "lt": (torch.lt, jnp.less, (V, V)),
    "le": (torch.le, jnp.less_equal, (V, V)),
    "gt": (torch.gt, jnp.greater, (V, V)),
    "ge": (torch.ge, jnp.greater_equal, (V, V)),
    "bitwise_and": (torch.bitwise_and, jnp.bitwise_and, (V, V),
                    ("bool", "bool")),
    "bitwise_or": (torch.bitwise_or, jnp.bitwise_or, (V, V),
                   ("bool", "bool")),
    "bitwise_not": (torch.bitwise_not, jnp.bitwise_not, (V,), ("bool",)),
    "where": (torch.where, jax.lax.select, (V, V, V), ("bool", "f32", "f32")),
    "masked_fill": (lambda x, p: x.masked_fill(p, -1e30),
                    lambda x, p: jnp.where(p, -1e30, x), (V, V),
                    ("f32", "bool")),
    "clamp": (lambda x: x.clamp(0.2, 0.8), lambda x: jnp.clip(x, 0.2, 0.8),
              (V,)),
    "floor_divide": (lambda x: x // 7, lambda x: x // 7, (V,), ("i32",)),
    "remainder": (lambda x: x % 7, lambda x: x % 7, (V,), ("i32",)),
    "exp": (torch.exp, jnp.exp, (V,)),
    "log": (torch.log, jnp.log, (V,)),
    "rsqrt": (torch.rsqrt, jax.lax.rsqrt, (V,)),
    "sqrt": (torch.sqrt, jnp.sqrt, (V,)),
    "tanh": (torch.tanh, jnp.tanh, (V,)),
    "erf": (torch.erf, jax.scipy.special.erf, (V,)),
    "sin": (torch.sin, jnp.sin, (V,)),
    "cos": (torch.cos, jnp.cos, (V,)),
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid, (V,)),
    "silu": (F.silu, jax.nn.silu, (V,)),
    "softplus": (F.softplus, jax.nn.softplus, (V,)),
    "silu_backward": (torch.ops.aten.silu_backward, _silu_bwd, (G, V)),
    "gelu_backward": (lambda g, x: torch.ops.aten.gelu_backward(
        g, x, approximate="tanh"), _gelu_bwd, (G, V)),
    "softplus_backward": (lambda g, x: torch.ops.aten.softplus_backward(
        g, x, 1.0, 20.0), _softplus_bwd, (G, V)),
    # beside the table (xla_flops)
    "cast f32 to bf16": (lambda x: x.to(torch.bfloat16),
                         lambda x: x.astype(jnp.bfloat16), (V,)),
    "cast bf16 to f32": (lambda x: x.float(), lambda x: x.astype(jnp.float32),
                         (V,), ("bf16",)),
    "cast i32 to f32": (lambda x: x.float(), lambda x: x.astype(jnp.float32),
                        (V,), ("i32",)),
    "cast bool to f32": (lambda x: x.float(),
                         lambda x: x.astype(jnp.float32), (V,), ("bool",)),
    "copy_ into bf16": (lambda x: torch.empty(N, dtype=torch.bfloat16)
                        .copy_(x), lambda x: x.astype(jnp.bfloat16), (V,)),
    "pow 2": (lambda x: x ** 2, lambda x: x ** 2, (V,)),
    "pow 2.5": (lambda x: x ** 2.5, lambda x: x ** 2.5, (V,)),
    "pow tensor": (torch.pow, jnp.power, (V, V)),
    "gelu tanh": (lambda x: F.gelu(x, approximate="tanh"), jax.nn.gelu, (V,)),
    "gelu erf": (F.gelu, lambda x: x * 0.5 * (1 + jax.scipy.special.erf(
        x / math.sqrt(2))), (V,)),
}
R, LONG = (10, 100), (16, 256)
REDUCTIONS = {
    "sum": (lambda x: x.sum(-1), lambda x: x.sum(-1), (R,)),
    "amax": (lambda x: x.amax(-1), lambda x: x.max(-1), (R,)),
    "mean": (lambda x: x.mean(-1), lambda x: x.mean(-1), (R,)),
    "_softmax": (lambda x: torch.softmax(x, -1),
                 lambda x: jax.nn.softmax(x, -1), (R,)),
    "_softmax_backward_data": (
        lambda g, y: torch.ops.aten._softmax_backward_data(
            g, y, -1, torch.float32),
        lambda g, y: y * (g - (g * y).sum(-1, keepdims=True)), (R, R)),
}


def _case(table, name, shapes=None):
    torch_fn, jnp_fn, default, *dts = table[name]
    shapes = shapes or default
    dts = dts[0] if dts else ["f32"] * len(shapes)
    xs = _inputs(shapes, dts)
    got = _port(torch_fn, *(_to_torch(x, d) for x, d in zip(xs, dts)))
    want = _xla(jnp_fn, *(_to_jnp(x, d) for x, d in zip(xs, dts)))
    return got, want


def test_every_rule_has_a_counterpart():
    assert set(dryrun._RULES) <= set(POINTWISE) | set(REDUCTIONS)


@pytest.mark.parametrize("name", sorted(POINTWISE))
def test_pointwise_rule_equals_xla(name):
    got, want = _case(POINTWISE, name)
    assert got == want, (got, want)


@pytest.mark.parametrize("shape", [R, LONG, (1000, 3)],
                         ids=["10x100", "16x256", "1000x3"])
@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_rule_within_xla_spread(name, shape):
    shapes = tuple(shape for _ in REDUCTIONS[name][2])
    (f, t), (xf, xt) = _case(REDUCTIONS, name, shapes)
    assert 0.75 * xf <= f <= 1.01 * xf, (f, xf)
    assert t == xt


@pytest.mark.parametrize("width", [1, 100])
def test_scatter_add_counts_its_adds(width):
    """torch's scatter_add along the last dimension, ``width`` elements
    a row, against ``.at[rows, cols].add`` of the same elements."""
    rows, cols = 1000, 128
    rng = np.random.default_rng(0)
    index = rng.integers(0, cols, size=(rows, width))
    src = rng.normal(size=(rows, width)).astype(np.float32)
    base = np.zeros((rows, cols), np.float32)
    got = _port(lambda b, i, s: b.scatter_add(-1, i, s),
                torch.from_numpy(base), torch.from_numpy(index),
                torch.from_numpy(src))
    r = np.broadcast_to(np.arange(rows)[:, None], index.shape)
    want = _xla(lambda b, i, s: b.at[r, i].add(s), jnp.asarray(base),
                jnp.asarray(index.astype(np.int32)), jnp.asarray(src))
    assert got == (want[0] - 3 * rows * width, want[1]), (got, want)


def test_olmo_smoke_layer_flops_within_5pct_of_xla():
    """One olmo-1b SMOKE layer's forward in f32 (batch 2, seq 64): the
    port's ``_layer`` counted on meta tensors against XLA's flops for the
    JAX ``_layer`` on the same shapes."""
    b, s = 2, 64
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              compute_dtype=torch.float32)
    jcfg = dataclasses.replace(j_get_config("olmo-1b", smoke=True),
                               compute_dtype=jnp.float32)
    jparams = j_transformer.init(jcfg, jax.random.PRNGKey(0))
    jlp = jax.tree_util.tree_map(lambda w: w[0], jparams["layers"])
    x = jnp.ones((b, s, cfg.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    want, _ = _xla(lambda x, lp, pos: j_transformer._layer(jcfg, x, lp, pos,
                                                           True),
                   x, jlp, pos)

    def meta(w):
        return torch.empty(tuple(w.shape), dtype=torch.float32,
                           device="meta")
    lp = jax.tree_util.tree_map(meta, jlp)
    got, _ = _port(lambda x, pos: transformer._layer(cfg, x, lp, pos, True),
                   torch.empty((b, s, cfg.d_model), device="meta"),
                   torch.empty((b, s), dtype=torch.int32, device="meta"))
    assert abs(got - want) <= 0.05 * want, (got, want)
