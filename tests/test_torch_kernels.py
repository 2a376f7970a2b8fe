"""The port's kernel modules against the JAX package, on the CPU.

The port's plain versions (what its wrappers run for CPU tensors) are held
against the Pallas kernels in interpret mode and the JAX references, on the
sweeps of tests/test_kernels.py.  Inputs are made with numpy and handed to
both; bf16 inputs are rounded from the same f32 values on both sides
(nearest even), so they are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gc_compact import gather_page_blocks as j_gather
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                  flash_attention_bwd)
from repro_torch.kernels.gc_compact import gather_page_blocks
from repro_torch.kernels.paged_attention import (
    MAX_SPLIT_PAGES, MAX_SPLITS, paged_attention, plan_splits)
from repro_torch.kernels.ssd_scan import ssd_scan

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(x, dtype):
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paged_inputs(rng, b, h, hkv, d, ptotal, page, npages, q_dtype,
                  kv_dtype):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(ptotal, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(ptotal, page, hkv, d)).astype(np.float32)
    pt = np.full((b, npages), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    for i in range(b):
        used = int(rng.integers(1, npages + 1))
        pt[i, :used] = rng.choice(ptotal, size=used, replace=False)
        lengths[i] = int(rng.integers((used - 1) * page + 1,
                                      used * page + 1))
    qj, qt = _both(q, q_dtype)
    kj, kt = _both(kp, kv_dtype)
    vj, vt = _both(vp, kv_dtype)
    return ((qj, kj, vj, jnp.asarray(pt), jnp.asarray(lengths)),
            (qt, kt, vt, torch.from_numpy(pt), torch.from_numpy(lengths)))


# tolerance: 2e-5 where q is f32 (every product is taken in f32 on both
# sides, only the summation order differs); 3e-2 for bf16, whose scores and
# weights are rounded to bf16 at different points.
@pytest.mark.parametrize("b,h,hkv,d,ptotal,page,npages", [
    (2, 4, 2, 64, 16, 8, 4), (3, 8, 8, 128, 32, 16, 6),
    (1, 4, 1, 32, 8, 8, 8),
])
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 3e-2),
    (torch.float32, torch.bfloat16, 2e-5),
])
def test_paged_attention_matches_jax(b, h, hkv, d, ptotal, page, npages,
                                     q_dtype, kv_dtype, tol):
    rng = np.random.default_rng(1000 * b + d)
    jargs, targs = _paged_inputs(rng, b, h, hkv, d, ptotal, page, npages,
                                 q_dtype, kv_dtype)
    out = paged_attention(*targs)
    assert out.dtype == q_dtype and out.shape == (b, h, d)
    for want in (j_paged(*jargs, interpret=True),
                 jref.paged_attention_ref(*jargs)):
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)


def test_paged_attention_zero_length_rows_are_zeros():
    rng = np.random.default_rng(7)
    jargs, targs = _paged_inputs(rng, 3, 4, 2, 32, 16, 8, 4, torch.float32,
                                 torch.float32)
    targs[4][1] = 0
    out = paged_attention(*targs)
    assert torch.count_nonzero(out[1]) == 0
    # the other rows are untouched by the empty one (2e-5, f32)
    want = np.asarray(jref.paged_attention_ref(*jargs))
    np.testing.assert_allclose(_np(out)[[0, 2]], want[[0, 2]], atol=2e-5,
                               rtol=2e-5)


# The sweep of tests/test_kernels.py::test_flash_attention, held against the
# JAX reference (the Pallas kernel cannot run on the installed JAX, ROADMAP
# F1).  Tolerance as there: 2e-5 for f32 (only the order of the sums
# differs), 2e-2 for bf16 (scores and weights are rounded to bf16 on both
# sides, by different libraries).
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 512, 4, 1, 32),
    (1, 256, 6, 3, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_matches_jax(b, s, h, hkv, d, dtype, causal):
    rng = np.random.default_rng(s + h + d)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.normal(size=shape).astype(np.float32), dtype)
        for shape in [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)])
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal)
    # what the model calls: on CPU tensors, the plain version itself
    assert torch.equal(ops.attention(qt, kt, vt, causal=causal), got)
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# K3's backward.  The plain version (the explicit formulas in f32) against
# jax.vjp of the JAX reference and against torch.autograd through the
# port's plain forward, in f32: only the order of the sums differs, so the
# gradients agree to ~1e-6 of the largest one (held to 2e-5).
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 64, 4, 2, 64), (1, 77, 6, 3, 96), (1, 100, 8, 1, 64),
    (2, 33, 4, 4, 96), (1, 1, 2, 1, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_ref_matches_jax(b, s, h, hkv, d, causal):
    import jax
    rng = np.random.default_rng(7 * s + d)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                            (b, s, h, d)]]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _both(x, torch.float32) for x in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal), qj, kj, vj)
    from_jax = vjp(doj)
    out, lse = ref.flash_attention_ref(qt, kt, vt, causal, return_lse=True)
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot, causal)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    from_autograd = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal), leaves, dot)
    # and what the model's gradient runs on CPU tensors: this backward
    through_ops = torch.autograd.grad(ops.attention(*leaves, causal=causal),
                                      leaves, dot)
    scale = max(float(np.abs(_np(g)).max()) for g in from_jax)
    for i, name in enumerate("qkv"):
        assert got[i].dtype == torch.float32 and got[i].shape == arrays[i].shape
        assert torch.equal(through_ops[i], got[i]), name
        for want in (from_jax[i], from_autograd[i]):
            np.testing.assert_allclose(_np(got[i]), _np(want),
                                       atol=2e-5 * scale, rtol=2e-5,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_lse(dtype, causal):
    """lse is the log-sum-exp of each row's scaled scores (f64 here), taken
    in f32 from f32 products whatever the inputs' dtype (1e-5 relative);
    the output is the one without lse, bit for bit."""
    rng = np.random.default_rng(11)
    b, s, h, hkv, d = 2, 50, 6, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dtype) for shape in [(b, s, h, d), (b, s, hkv, d),
                                        (b, s, hkv, d)])
    out, lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal))
    qg = q.double().reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) / np.sqrt(d)
    if causal:
        scores = scores.masked_fill(~torch.ones((s, s), dtype=torch.bool)
                                    .tril(), float("-inf"))
    want = torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    # Only CPU tensors run the plain version, and only meta tensors the
    # meta branch (shapes, no work, no launch); tensors on more than one
    # device must reach the kernel or raise.
    rng = np.random.default_rng(3)
    _, targs = _paged_inputs(rng, 2, 4, 2, 64, 16, 8, 4, torch.float32,
                             torch.float32)
    with pytest.raises(ValueError):
        paged_attention(targs[0].to("meta"), *targs[1:])
    assert paged_attention(*(t.to("meta") for t in targs)).is_meta
    pool = torch.zeros((2, 8, 4, 16), device="meta")
    with pytest.raises(ValueError):
        gather_page_blocks(pool, np.array([0, 1], np.int32), 2,
                           torch.zeros((2, 8, 4, 16)))
    assert gather_page_blocks(pool, np.array([0, 1], np.int32), 2,
                              torch.zeros_like(pool)).is_meta
    q = torch.zeros((1, 8, 4, 16), device="meta")
    k = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention(q.clone().requires_grad_(), k, k)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q, torch.zeros((1, 4, 8)), q)
    assert flash_attention(q, q, q).is_meta
    assert all(g.is_meta for g in flash_attention_bwd(
        q, q, q, q, torch.zeros((1, 4, 8), device="meta"), q))
    _, targs = _ssd_inputs(0, 1, 16, 2, 4, 8)
    with pytest.raises(ValueError):
        ssd_scan(targs[0].to("meta"), *targs[1:], 8)
    assert all(t.is_meta for t in ssd_scan(*(t.to("meta") for t in targs),
                                          8))


@pytest.mark.parametrize("seed,n,block_pages,density", [
    (0, 64, 4, 0.6), (1, 256, 4, 0.3), (2, 48, 8, 0.8), (3, 33, 1, 0.5),
    (4, 128, 2, 0.95), (5, 16, 4, 0.0),
])
def test_compact_plan_identical(seed, n, block_pages, density):
    valid = np.random.default_rng(seed).random(n) < density
    jb, jt, jr = jops.compact_plan(valid, block_pages)
    tb, tt, tr = ops.compact_plan(valid, block_pages)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tt, jt)
    assert tb.dtype == jb.dtype and tt.dtype == jt.dtype
    assert tr == jr


@pytest.mark.parametrize("ptotal,page,d,blockp", [
    (32, 8, 16, 4), (64, 4, 8, 8), (16, 8, 32, 4), (48, 8, 16, 1),
])
def test_compact_pages_matches_jax_kernel_path(ptotal, page, d, blockp):
    rng = np.random.default_rng(ptotal + blockp)
    pool = rng.normal(size=(ptotal, page, d)).astype(np.float32)
    valid = rng.random(ptotal) < 0.6
    jpacked, jnew, jdmas = jops.compact_pages(
        jnp.asarray(pool), valid, block_pages=blockp, use_pallas=True,
        interpret=True)
    packed, new_index, dmas = ops.compact_pages(
        torch.from_numpy(pool), valid, block_pages=blockp)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(new_index, np.asarray(jnew))
    assert dmas == jdmas


def test_compact_pages_ref_matches_jax():
    rng = np.random.default_rng(11)
    pool = rng.normal(size=(24, 4, 8)).astype(np.float32)
    valid = rng.random(24) < 0.5
    jpacked, jnew = jref.compact_pages_ref(jnp.asarray(pool),
                                           jnp.asarray(valid))
    packed, new_index = ref.compact_pages_ref(torch.from_numpy(pool), valid)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(new_index.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("block_pages,dst_page", [(1, 0), (4, 0), (2, 6)])
def test_gather_page_blocks_every_plane(block_pages, dst_page):
    # Each plane of the port's multi-plane gather equals the Pallas kernel
    # on that plane; pages of `out` outside the destination stay as they
    # were.
    rng = np.random.default_rng(block_pages)
    planes, ptotal, page, d = 3, 16, 4, 8
    pool = rng.normal(size=(planes, ptotal, page, d)).astype(np.float32)
    ids = rng.choice(ptotal // block_pages, size=3, replace=False) \
        .astype(np.int32)
    out = torch.full((planes, ptotal, page, d), 7.0)
    gather_page_blocks(torch.from_numpy(pool), ids, block_pages, out,
                       dst_page=dst_page)
    n = len(ids) * block_pages
    for i in range(planes):
        want = j_gather(jnp.asarray(pool[i]), jnp.asarray(ids),
                        block_pages=block_pages, interpret=True)
        np.testing.assert_array_equal(
            out[i, dst_page:dst_page + n].numpy(), np.asarray(want))
    kept = torch.ones(ptotal, dtype=torch.bool)
    kept[dst_page:dst_page + n] = False
    assert bool((out[:, kept] == 7.0).all())


@pytest.mark.parametrize("ptotal,page,d,blockp", [
    (32, 8, 16, 4), (64, 4, 8, 8), (16, 8, 32, 4), (48, 8, 16, 1),
])
def test_compact_units_match_jax_kernel_path(ptotal, page, d, blockp):
    # The one-launch unit table gives the JAX kernel path's destination
    # order, new_index and copy count.
    rng = np.random.default_rng(ptotal + blockp)
    pool = rng.normal(size=(ptotal, page, d)).astype(np.float32)
    valid = rng.random(ptotal) < 0.6
    jpacked, jnew, jdmas = jops.compact_pages(
        jnp.asarray(pool), valid, block_pages=blockp, use_pallas=True,
        interpret=True)
    units, new_index, dmas = ops.compact_units(valid, blockp)
    assert units.dtype == np.int32 and units.shape == (dmas, 3)
    n_live = int(valid.sum())
    packed = np.zeros_like(pool)
    for src, dst, n in units:
        packed[dst:dst + n] = pool[src:src + n]
    np.testing.assert_array_equal(packed[:n_live],
                                  np.asarray(jpacked)[:n_live])
    np.testing.assert_array_equal(new_index, np.asarray(jnew))
    assert dmas == jdmas
    # destinations are consecutive from page 0: blocks, then tails
    np.testing.assert_array_equal(units[:, 1],
                                  np.cumsum(units[:, 2]) - units[:, 2])
    assert list(units[:, 2]) == sorted(units[:, 2], reverse=True)


# (n_pages, page_size, batch, hkv): the serve shape, L-MHA, L-GQA,
# phi3-medium's 10 kv heads, and shapes around the split's floor and
# ceiling.
@pytest.mark.parametrize("n_pages,page,b,hkv", [
    (12, 4, 4, 16), (256, 16, 8, 16), (256, 16, 4, 2), (256, 16, 5, 10),
    (1, 16, 1, 1), (0, 16, 2, 2), (8192, 1, 1, 1), (33, 8, 1, 1),
    (100000, 16, 1, 1),
])
def test_paged_attention_split_plan(n_pages, page, b, hkv):
    pages, splits = plan_splits(n_pages, page, b, hkv, 132)
    tokens = pages * page                     # a whole number of pages
    assert pages >= 1 and splits >= 1
    assert splits * pages >= n_pages          # the splits cover the context
    assert (splits - 1) * pages < max(n_pages, 1)   # and no split is empty
    assert tokens >= min(128, max(n_pages, 1) * page)
    assert pages <= MAX_SPLIT_PAGES
    if pages < MAX_SPLIT_PAGES:               # only the page cap exceeds it
        assert splits <= MAX_SPLITS
    if n_pages * page <= 128:
        assert splits == 1
    if (n_pages, page, b, hkv) == (12, 4, 4, 16):      # the serve shape
        assert splits == 1
    if (n_pages, page, b, hkv) == (256, 16, 4, 2):     # L-GQA
        assert b * hkv * splits >= 132


def _ssd_inputs(seed, b, s, h, p, n, dt_range=(0.1, 0.9), with_state=False):
    """numpy inputs in the ranges of tests/test_kernels.py::test_ssd_scan,
    as (JAX arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, s, h, p)),
              rng.uniform(*dt_range, size=(b, s, h)),
              -rng.uniform(0.5, 1.5, size=(h,)),
              rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n))]
    if with_state:
        arrays.append(rng.normal(size=(b, h, p, n)))
    arrays = [x.astype(np.float32) for x in arrays]
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(x) for x in arrays])


# JAX's tolerance for the SSD scan (tests/test_kernels.py: atol 5e-5): f32
# throughout, only the order of the sums differs.
SSD_TOL = 5e-5
# (B, S, H, P, N, chunk): tests/test_kernels.py::test_ssd_scan's sweep,
# then tests/test_models.py::test_ssd_chunked_matches_recurrence's shape.
SSD_SHAPES = [(2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32),
              (2, 32, 4, 4, 8, 8), (2, 32, 3, 4, 5, 8)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_ref_matches_jax(b, s, h, p, n, chunk):
    jargs, targs = _ssd_inputs(s + n, b, s, h, p, n)
    y, st = ref.ssd_scan_ref(*targs)
    wy, wst = jref.ssd_scan_ref(*jargs)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=SSD_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_ref_matches_jax(b, s, h, p, n, chunk, with_state):
    jargs, targs = _ssd_inputs(s + p, b, s, h, p, n, with_state=with_state)
    y, st = ref.ssd_chunked_ref(*targs[:5], chunk, *targs[5:])
    wy, wst = j_ssd_chunked(*jargs[:5], chunk, *jargs[5:])
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=SSD_TOL)
    # what the model calls: on CPU tensors, the plain version itself
    oy, ost = ops.ssd(*targs[:5], chunk, *targs[5:])
    assert torch.equal(oy, y) and torch.equal(ost, st)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_plain_versions_match_pallas_kernel(b, s, h, p, n, chunk):
    jargs, targs = _ssd_inputs(s * h, b, s, h, p, n)
    wy, wst = j_ssd_scan(*jargs, chunk=chunk, interpret=True)
    for y, st in (ref.ssd_chunked_ref(*targs, chunk),
                  ref.ssd_scan_ref(*targs), ssd_scan(*targs, chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=SSD_TOL)


def test_ssd_chunked_ref_stays_finite_where_the_decay_overflows():
    # dA = dt * a about -0.72 a step: the cumsum reaches about -93 within
    # one 128-step chunk, and exp(+93) over the upper triangle is inf in f32
    # (inf * 0 = NaN if the mask came after the exp).
    jargs, targs = _ssd_inputs(9, 1, 256, 2, 8, 16, dt_range=(0.7, 0.82))
    a = torch.full((2,), -0.95)
    dA_cs = torch.cumsum(targs[1] * a, dim=1)
    assert float(dA_cs[:, :128].min()) < -88.8     # exp(-min) is inf in f32
    y, st = ref.ssd_chunked_ref(targs[0], targs[1], a, *targs[3:], 128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    # The cumsum reaches about -190 over the two chunks; its f32 rounding
    # (~1e-5 absolute) is ~1e-5 relative in each exp, on outputs up to ~10:
    # JAX's atol plus the same rtol.
    tol = dict(atol=SSD_TOL, rtol=SSD_TOL)
    wy, wst = j_ssd_chunked(jargs[0], jargs[1], jnp.asarray(a.numpy()),
                            *jargs[3:], 128)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), **tol)
    sy, sst = ref.ssd_scan_ref(targs[0], targs[1], a, *targs[3:])
    np.testing.assert_allclose(y.numpy(), sy.numpy(), **tol)
    np.testing.assert_allclose(st.numpy(), sst.numpy(), **tol)
