"""The SSD scan's gradient in the port against the JAX package, on the CPU.

``ref.ssd_chunked_bwd_ref`` (the plain version of the backward kernel, the
explicit formulas of the chunked form) is held against ``jax.vjp`` of
``repro.models.ssm.ssd_chunked``, with and without an initial state and
with the final state's gradient zero or not; ``SSDScan`` (the
``torch.autograd.Function`` that the model's scan goes through) against
``gradcheck`` in float64 and against autograd through the plain forward.
Inputs are made with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan, ssd_scan_bwd

NAMES = ("dx", "ddt", "da", "dB", "dC", "dinit")
# (B, S, H, P, N, chunk): tests/test_kernels.py::test_ssd_scan's sweep,
# then tests/test_models.py::test_ssd_chunked_matches_recurrence's shape.
SSD_SHAPES = [(2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32),
              (2, 32, 4, 4, 8, 8), (2, 32, 3, 4, 5, 8)]
# f32 on both sides, the same terms summed in other orders: each gradient
# agrees with JAX's to ~6e-6 of its largest magnitude (da, a sum over every
# step, is the worst); held to 5e-5 of it.
TOL = 5e-5


def _inputs(seed, b, s, h, p, n, dt_range=(0.1, 0.9), with_state=False,
            with_dfinal=False, a=None):
    """numpy f32 (x, dt, a, B, C, initial state or None, dy, dfinal or
    None) in the ranges of tests/test_kernels.py::test_ssd_scan."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, s, h, p)), rng.uniform(*dt_range, size=(b, s, h)),
           -rng.uniform(0.5, 1.5, size=(h,)) if a is None else np.full((h,), a),
           rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)),
           rng.normal(size=(b, h, p, n)) if with_state else None,
           rng.normal(size=(b, s, h, p)),
           rng.normal(size=(b, h, p, n)) if with_dfinal else None]
    return [None if v is None else v.astype(np.float32) for v in out]


def _jax_grads(arrays, chunk):
    """jax.vjp of the JAX package's chunked scan: (dx, ddt, da, dB, dC,
    dinit or None)."""
    x, dt, a, bm, cm, init, dy, dfinal = arrays
    primals = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    if init is not None:
        primals.append(jnp.asarray(init))
    (_, final), vjp = jax.vjp(
        lambda *args: j_ssd_chunked(*args[:5], chunk, *args[5:]), *primals)
    dfin = jnp.zeros_like(final) if dfinal is None else jnp.asarray(dfinal)
    grads = [np.asarray(g) for g in vjp((jnp.asarray(dy), dfin))]
    return grads + [None] * (6 - len(grads))


def _ref_grads(arrays, chunk):
    t = [None if v is None else torch.from_numpy(v) for v in arrays]
    return ref.ssd_chunked_bwd_ref(*t[:5], chunk, *t[5:])


def _assert_close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_dfinal", [False, True])
def test_ssd_chunked_bwd_ref_matches_jax_vjp(b, s, h, p, n, chunk,
                                             with_state, with_dfinal):
    arrays = _inputs(s + p + n, b, s, h, p, n, with_state=with_state,
                     with_dfinal=with_dfinal)
    _assert_close(_ref_grads(arrays, chunk), _jax_grads(arrays, chunk))


def test_ssd_chunked_bwd_ref_stays_finite_where_the_decay_overflows():
    # dA = dt * a about -0.72 a step: the cumsum reaches about -93 within one
    # 128-step chunk, and exp(+93) over the upper triangle is inf in f32; the
    # mask comes before the exp, so no gradient meets inf * 0.  The cumsum's
    # f32 rounding (~1e-5 absolute at -190) is ~1e-5 relative in each exp:
    # held to TOL of each gradient's largest magnitude, as above.
    arrays = _inputs(9, 1, 256, 2, 8, 16, dt_range=(0.7, 0.82), a=-0.95,
                     with_state=True, with_dfinal=True)
    dA_cs = np.cumsum(arrays[1] * arrays[2], axis=1)
    assert float(dA_cs[:, :128].min()) < -88.8     # exp(-min) is inf in f32
    got = _ref_grads(arrays, 128)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_close(got, _jax_grads(arrays, 128))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_function_passes_gradcheck(with_state):
    """SSDScan on CPU tensors (the plain forward and backward) against
    finite differences in float64, both outputs, every input."""
    arrays = _inputs(3, 1, 16, 2, 4, 8, with_state=with_state)[:6]
    args = [None if v is None else
            torch.from_numpy(v).double().requires_grad_() for v in arrays]
    x, dt, a, bm, cm, init = args

    def fn(*inputs):
        return SSDScan.apply(*inputs[:5], 8, *inputs[5:] or [None])

    inputs = [x, dt, a, bm, cm] + ([init] if with_state else [])
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_gradients_equal_autograd_through_the_plain_scan(with_state):
    """What the model calls (``ops.ssd`` on tensors that need a gradient
    goes through SSDScan) against autograd through ``ref.ssd_chunked_ref``,
    on a loss that reads both outputs: f32, the same terms in other orders,
    held to TOL of each gradient's largest magnitude."""
    arrays = _inputs(4, 2, 64, 3, 8, 16, with_state=with_state,
                     with_dfinal=True)

    def grads(fn):
        leaves = [torch.from_numpy(v).requires_grad_()
                  for v in arrays[:6] if v is not None]
        y, final = fn(*leaves[:5], 16, *leaves[5:])
        loss = (y * torch.from_numpy(arrays[6])).sum() + \
            (final * torch.from_numpy(arrays[7])).sum()
        return torch.autograd.grad(loss, leaves)

    got = grads(ops.ssd)
    want = [g.numpy() for g in grads(ref.ssd_chunked_ref)]
    _assert_close(list(got) + [None] * (6 - len(got)),
                  want + [None] * (6 - len(want)))


def test_ssd_scan_bwd_on_cpu_tensors_is_the_plain_version():
    arrays = _inputs(5, 1, 32, 2, 4, 8, with_state=True, with_dfinal=True)
    t = [torch.from_numpy(v) for v in arrays]
    got = ssd_scan_bwd(*t[:5], 8, *t[5:])
    want = ref.ssd_chunked_bwd_ref(*t[:5], 8, *t[5:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_scan_without_grad_runs_the_forward_alone():
    """No graph where none is wanted: under no_grad, or with no input that
    requires a gradient, the outputs carry no grad_fn."""
    t = [torch.from_numpy(v) for v in _inputs(6, 1, 32, 2, 4, 8)[:5]]
    y, final = ssd_scan(*t, 8)
    assert y.grad_fn is None and final.grad_fn is None
    x = t[0].clone().requires_grad_()
    with torch.no_grad():
        y, final = ssd_scan(x, *t[1:], 8)
    assert y.grad_fn is None
    y, final = ssd_scan(x, *t[1:], 8)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
