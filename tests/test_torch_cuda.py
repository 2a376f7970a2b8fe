"""The hand-written kernels against their plain versions, on the card.

Skipped on a machine with no card.  On one:
  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gc_compact, ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# tolerance: 2e-3 for f32 q (the plain version's einsum and the kernel sum
# in different orders on the card); 3e-2 where q is bf16 (the plain version
# rounds scores and weights to bf16, the kernel keeps them in f32).
@pytest.mark.parametrize("b,h,hkv,d,ptotal,page,npages", [
    (2, 4, 2, 64, 16, 8, 4), (3, 8, 8, 128, 32, 16, 6),
    (1, 4, 1, 32, 8, 8, 8), (4, 32, 32, 96, 64, 4, 12),
    (2, 16, 2, 256, 32, 16, 5),
])
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 2e-3),
    (torch.float32, torch.bfloat16, 2e-3),
    (torch.bfloat16, torch.bfloat16, 3e-2),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_paged_attention_kernel_matches_plain(cuda, b, h, hkv, d, ptotal,
                                              page, npages, q_dtype,
                                              kv_dtype, tol):
    rng = np.random.default_rng(b * d + npages)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(ptotal, page, hkv, d))
                               .astype(np.float32)) for _ in range(2))
    pt = np.full((b, npages), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    for i in range(b):
        used = int(rng.integers(1, npages + 1))
        pt[i, :used] = rng.choice(ptotal, size=used, replace=False)
        lengths[i] = int(rng.integers((used - 1) * page + 1, used * page + 1))
    lengths[-1] = 0                     # an empty row: zeros from both
    args = (q.to(cuda, q_dtype), kp.to(cuda, kv_dtype), vp.to(cuda, kv_dtype),
            torch.from_numpy(pt).to(cuda), torch.from_numpy(lengths).to(cuda))
    before = pa.launches
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = ref.paged_attention_ref(*args)
    assert out.dtype == q_dtype and out.shape == (b, h, d)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.parametrize("planes,ptotal,page,d,blockp,dtype", [
    (1, 32, 8, 16, 4, torch.float32), (4, 64, 4, 8, 8, torch.float32),
    (32, 256, 4, 256, 4, torch.bfloat16), (3, 48, 8, 16, 1, torch.bfloat16),
])
def test_compact_pages_kernel_matches_plain(cuda, planes, ptotal, page, d,
                                            blockp, dtype):
    rng = np.random.default_rng(ptotal + blockp)
    pool = torch.from_numpy(rng.normal(size=(planes, ptotal, page, d))
                            .astype(np.float32)).to(cuda, dtype)
    valid = rng.random(ptotal) < 0.6
    n_live = int(valid.sum())
    out = pool.clone()
    before = gc_compact.launches
    _, new_index, dmas = ops.compact_pages(pool, valid, blockp, out=out)
    torch.cuda.synchronize()
    # one launch for blocks and tails together, none where nothing is live
    assert gc_compact.launches - before == int(valid.any())
    # the CPU run of the same plan (held against the JAX package's kernel
    # path by test_torch_kernels.py)
    want, want_index, want_dmas = ops.compact_pages(pool.cpu(), valid, blockp)
    np.testing.assert_array_equal(new_index, want_index)
    assert dmas == want_dmas
    assert torch.equal(out[:, :n_live].cpu(), want[:, :n_live])
    assert torch.equal(out[:, n_live:], pool[:, n_live:])   # tail kept


def test_serve_driver_runs_through_both_kernels(cuda):
    from repro_torch.launch import serve
    pa.launches = gc_compact.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(["--arch", "olmo-1b"]) == 0
    assert buf.getvalue().startswith(
        "completed=24/24 decode_steps=62 compaction_steps=12 "
        "compaction_dmas=360 alloc_failures=0")
    assert pa.launches == 62
    # one launch per compaction: each of the 12 moves a page
    assert gc_compact.launches == 12


def _split_inputs(rng, cuda, b, h, hkv, d, page, n_pages, lengths, q_dtype,
                  kv_dtype, p_total=None):
    """Rows mapped to distinct random pages up to their length, the rest of
    each table unmapped."""
    p_total = p_total or b * n_pages
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(p_total, page, hkv, d))
                               .astype(np.float32)) for _ in range(2))
    pages = rng.permutation(p_total)[:b * n_pages].reshape(b, n_pages)
    used = -(-np.asarray(lengths) // page)
    pt = np.where(np.arange(n_pages)[None] < used[:, None], pages, -1)
    return [q.to(cuda, q_dtype), kp.to(cuda, kv_dtype), vp.to(cuda, kv_dtype),
            torch.from_numpy(pt.astype(np.int32)).to(cuda),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(cuda)]


def _device_kernel_names(call, tries=3, calls=1):
    """The names of the kernels that `calls` calls launch, by the profiler,
    as a list (one entry a launch).  The profiler on the card now and then
    records no device event for a window, or misses the launches queued as
    it starts (chip_smoke.py retries for the same reason), so an empty
    window is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile
    call()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if names:
            return names
    return []


def _k1_kernels_per_call(args):
    return sum(1 for nm in _device_kernel_names(lambda: pa.paged_attention(*args))
               if "paged_attention" in nm)


# The long-context shapes of chip_smoke.py: L-MHA (olmo-1b widths, lengths
# 1024-4096) and L-GQA (starcoder2-3b's 24 heads over 2, 4096 each), page
# 16, f32 q over a bf16 pool.  Tolerance 2e-3: f32 arithmetic on both
# sides, sums in different orders.
@pytest.mark.parametrize("b,h,hkv,lo", [(8, 16, 16, 1024), (4, 24, 2, 4096)])
def test_paged_attention_kernel_long_context(cuda, b, h, hkv, lo):
    rng = np.random.default_rng(h + hkv)
    lengths = rng.integers(lo, 4097, size=b)
    args = _split_inputs(rng, cuda, b, h, hkv, 128, 16, 256, lengths,
                         torch.float32, torch.bfloat16)
    before = pa.launches
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    torch.testing.assert_close(out, ref.paged_attention_ref(*args),
                               atol=2e-3, rtol=2e-3)
    assert _k1_kernels_per_call(args) == 1


def _check_split_edges(cuda, b, h, hkv, d, page, n_pages, q_dtype, kv_dtype,
                       seed):
    """Split edges, with the split the wrapper plans (several splits a row):
    a length ending exactly on a split boundary, one token past it, one
    inside the first split, an unmapped page inside a later split, a split
    whose pages are all unmapped, and an empty row.  Tolerance as in
    test_paged_attention_kernel_matches_plain: 2e-3 for f32 q, 3e-2 for
    bf16 q.  Returns the plan."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pps, splits = pa.plan_splits(n_pages, page, b, hkv, sms)
    assert splits >= 3
    edge = pps * page
    lengths = [edge, n_pages * page, edge + 1, 5, 0][:b]
    rng = np.random.default_rng(seed)
    args = _split_inputs(rng, cuda, len(lengths), h, hkv, d, page, n_pages,
                         lengths, q_dtype, kv_dtype)
    args[3][1, pps + 1] = -1                 # inside the second split
    args[3][1, 2 * pps:3 * pps] = -1         # the third split: no valid slot
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    tol = 2e-3 if q_dtype == torch.float32 else 3e-2
    assert out.dtype == q_dtype
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    if len(lengths) == 5:
        assert torch.count_nonzero(out[4]) == 0
    return pps, splits


# g = 1, 5 (phi3-medium's 40 over 10) and 12 (starcoder2-3b's 24 over 2),
# at every D the kernel takes and all four dtype pairs, so bf16 q goes
# through the merge's store too.
@pytest.mark.parametrize("h,hkv", [(16, 16), (40, 10), (24, 2)])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_paged_attention_kernel_split_edges(cuda, h, hkv, d, q_dtype,
                                            kv_dtype):
    _check_split_edges(cuda, 5, h, hkv, d, 16, 256, q_dtype, kv_dtype,
                       h + d)


# The shallower rings, which only large g * D takes: at D = 256 over an f32
# pool, 3 stages fit up to g = 15, 2 up to g = 45 and 1 up to g = 76, the
# most the kernel before the split-KV design took too.
@pytest.mark.parametrize("g,stages", [(16, 2), (76, 1)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_shallow_rings(cuda, g, stages, q_dtype):
    b, hkv, d = 3, 1, 256
    pps, splits = _check_split_edges(cuda, b, g * hkv, hkv, d, 16, 64,
                                     q_dtype, torch.float32, g)
    lib = pa._lib()
    fits = [n for n in (3, 2, 1) if lib.paged_attention_smem_bytes(
        g, d, 4, pps, splits, n) <= pa._MAX_SMEM]
    assert fits[0] == stages


def test_paged_attention_refuses_what_it_cannot_take(cuda):
    rng = np.random.default_rng(3)

    def args(h, hkv, d, q_dtype=torch.float32, kv_dtype=torch.float32):
        return _split_inputs(rng, cuda, 1, h, hkv, d, 16, 4, [40], q_dtype,
                             kv_dtype)

    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_attention(*args(77, 1, 256))   # g = 77 at D = 256, f32 pool
    with pytest.raises(ValueError, match="unsupported shapes"):
        pa.paged_attention(*args(4, 2, 264))    # D > 256
    with pytest.raises(ValueError, match="unsupported shapes"):
        pa.paged_attention(*args(4, 2, 36))     # D % 8
    with pytest.raises(TypeError, match="float32 or"):
        pa.paged_attention(*args(4, 2, 64, torch.float16))


def test_paged_attention_kernel_on_two_streams_at_once(cuda):
    # Calls in flight on two streams at once, with several splits a row:
    # each stream has arrival counters of its own, so no CTA merges the
    # other stream's partials.
    rng = np.random.default_rng(11)
    inputs = [_split_inputs(rng, cuda, 4, 24, 2, 128, 16, 256,
                            rng.integers(1, 4097, size=4), torch.float32,
                            torch.bfloat16) for _ in range(2)]
    wants = [ref.paged_attention_ref(*args) for args in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(pa.paged_attention(*inputs[i]))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        for out in got:
            torch.testing.assert_close(out, want, atol=2e-3, rtol=2e-3)


def test_paged_attention_kernel_is_deterministic(cuda):
    # Two calls in a row give the same bits: the merge runs in split order,
    # and the arrival counters are back at 0 after each call.
    rng = np.random.default_rng(5)
    args = _split_inputs(rng, cuda, 4, 24, 2, 128, 16, 256,
                         rng.integers(1, 4097, size=4), torch.float32,
                         torch.bfloat16)
    first = pa.paged_attention(*args)
    second = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_gather_page_units_blocks_and_tails_in_one_launch(cuda):
    rng = np.random.default_rng(9)
    pool = torch.from_numpy(rng.normal(size=(6, 64, 4, 64))
                            .astype(np.float32)).to(cuda, torch.bfloat16)
    valid = rng.random(64) < 0.7
    units, _, _ = ops.compact_units(valid, 4)
    assert (units[:, 2] == 4).any() and (units[:, 2] == 1).any()
    units[:, 1] += 3                          # a non-zero destination page
    out = torch.full((6, 64, 4, 64), 5.0, device=cuda, dtype=torch.bfloat16)
    want = gc_compact.gather_page_units(pool.cpu(), units, out.cpu())
    before = gc_compact.launches
    gc_compact.gather_page_units(pool, units, out)
    torch.cuda.synchronize()
    assert gc_compact.launches == before + 1
    assert torch.equal(out.cpu(), want)


# tolerance: 2e-3 for f32 (the SIMT kernel and the plain version's einsums
# sum in different orders); 2e-2 for bf16 (the plain version rounds the
# scores to bf16, the tensor-core kernel keeps them in f32; both round the
# softmax weights to bf16 before the product with V, the kernel before it
# divides by the row sum, the plain version after).
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 512, 4, 1, 32),
    (1, 256, 6, 3, 64), (1, 1000, 8, 2, 64), (2, 77, 12, 1, 96),
    (1, 1, 4, 4, 128), (1, 300, 24, 2, 128), (1, 130, 4, 4, 256),
    (1, 65, 2, 1, 40),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, hkv, d, dtype,
                                              tol, causal):
    gen = torch.Generator(cuda).manual_seed(b * s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)])
    before = fa.launches
    out = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == (b, s, h, d)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


# bf16 cases of the tensor-core kernel beyond the sweep: the olmo-1b prefill
# shape; a diagonal tile cut short by S (200 rows against 128-row tiles);
# and nearly one-hot rows (q x 30, score std ~30, so a row's max jumps by
# hundreds between KV tiles and the rescaling must be exact).  The third is
# held against the plain version in f32 on the same bf16 values: the bf16
# plain version rounds scores near 100 to steps of 0.5, which alone moves a
# weight by e^0.25.  Then the MoE prefills: granite-moe-3b-a800m's (24
# heads over 8, D 64) and grok-1-314b's (48 over 8, D 128).  Tolerance
# 2e-2 (bf16 weights and output).
@pytest.mark.parametrize("b,s,h,hkv,d,q_scale,plain_dtype", [
    (2, 4096, 16, 16, 128, 1.0, torch.bfloat16),
    (1, 200, 4, 2, 128, 1.0, torch.bfloat16),
    (1, 2048, 4, 2, 128, 30.0, torch.float32),
    (2, 4096, 24, 8, 64, 1.0, torch.bfloat16),
    (1, 2048, 48, 8, 128, 1.0, torch.bfloat16),
])
def test_flash_attention_bf16_kernel_cases(cuda, b, s, h, hkv, d, q_scale,
                                           plain_dtype):
    gen = torch.Generator(cuda).manual_seed(s + h)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)])
    q, k, v = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(*(t.to(plain_dtype) for t in (q, k, v)))
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h, d)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.randn((1, 64, 4, 64), device=cuda)
    k = torch.randn((1, 64, 2, 64), device=cuda)
    # an input that needs a gradient goes through the backward kernel
    before = (fa.launches, fa.bwd_launches)
    out = fa.flash_attention(q.clone().requires_grad_(), k, k)
    assert out.requires_grad
    out.sum().backward()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():     # no graph: the forward kernel alone
        assert not fa.flash_attention(q.clone().requires_grad_(), k,
                                      k).requires_grad
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, k)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :60].contiguous(),
                           k[:, :, :, :60].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :60].contiguous(), k[..., :60].contiguous(),
                           k[..., :60].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :1].expand(1, 64, 3, 64).contiguous(),
                           k[:, :, :1].expand(1, 64, 3, 64).contiguous())


def _bwd_inputs(cuda, b, s, h, hkv, d, dtype, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)])
    dout = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    return q, k, v, dout


def _check_bwd(cuda, b, s, h, hkv, d, dtype, causal):
    """K3's forward (with lse) and backward kernels against the plain
    backward (f32 throughout) on the same out and lse.  Tolerance: f32
    inputs take every product in f32 on both sides, summed in other orders,
    so results agree to ~1e-6 of the largest gradient (held to 1e-4).  bf16
    outputs are rounded to bf16 (2^-9 relative), and at D = 64, 96 and 128
    the kernel also rounds P and dS to bf16 before their products on the
    tensor cores; held to 1e-2 of the largest gradient.  The scale is the
    largest of dq, dk and dv: at S = 1 dq is zero in exact arithmetic and
    both sides give rounding noise."""
    q, k, v, dout = _bwd_inputs(cuda, b, s, h, hkv, d, dtype, b * s + h + d)
    out, lse = fa._forward(q, k, v, causal, True)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    scale = max(float(w.float().abs().max()) for w in want)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale,
                                   rtol=tol, msg=f"d{name}")
    # two calls give the same bits
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


# The split edges of the 64-row tiles (S = 1, 63, 64, 65, 200) for MHA and
# for groups of 2 and 12 query heads a KV head, at D = 64.
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (12, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel_split_edges(cuda, s, h, hkv, dtype,
                                                causal):
    _check_bwd(cuda, 2, s, h, hkv, 64, dtype, causal)


# The wgmma route (bf16 at D = 64, 96 and 128) at the edges of its tiles:
# 64 query rows a dk/dv ring stage, 128 keys a dk/dv CTA, 128 rows a dq CTA
# and 128 keys a dq ring stage; groups of 1, 2 and 12 query heads a KV
# head (at batch 1 the two GQA groups are split over CTAs).
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 200, 4096])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (12, 1)])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_wgmma_tile_edges(cuda, s, h, hkv, d, causal):
    _check_bwd(cuda, 1, s, h, hkv, d, torch.bfloat16, causal)


# Where the dk/dv kernel would give the card fewer CTAs than it has SMs,
# a group's query heads are split over CTAs whose f32 partial sums a
# fourth launch adds in split order; otherwise one CTA sums the group.
# starcoder2-3b's 24 heads over 2 take the split; (2, 4096, 12 over 4)
# gives 256 CTAs and sums each group of 3 in one.
@pytest.mark.parametrize("b,s,h,hkv", [(1, 2048, 24, 2), (2, 4096, 12, 4),
                                       (1, 200, 12, 1), (1, 129, 4, 4)])
def test_flash_attention_bwd_splits_groups_only_where_ctas_are_few(
        cuda, b, s, h, hkv):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ctas = (s + 127) // 128 * hkv * b
    split = h > hkv and ctas < sms
    work = fa._bwd_lib().flash_attention_bwd_workspace(1, b, s, h, hkv, 128)
    delta = (b * h * s + 3) // 4 * 4
    assert (work > delta) == split
    _check_bwd(cuda, b, s, h, hkv, 128, torch.bfloat16, True)


# Every head width class: D 16 and 40 (one 64-column group, part used), 96
# (two groups, the second half used), 128, 192 and 256 (32-row tiles).
@pytest.mark.parametrize("d", [16, 40, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel_head_widths(cuda, d, dtype, causal):
    _check_bwd(cuda, 1, 100, 4, 2, d, dtype, causal)


# The [K3 bwd] shapes of chip_smoke.py: olmo-1b's training shape,
# starcoder2-3b's GQA (24 heads over 2), phi3-mini's D = 96, a ragged f32
# case, granite-moe-3b-a800m's training shape (24 over 8, D 64) and
# grok-1-314b's GQA (48 over 8, D 128).
@pytest.mark.parametrize("b,s,h,hkv,d,dtype,causal", [
    (2, 4096, 16, 16, 128, torch.bfloat16, True),
    (1, 2048, 24, 2, 128, torch.bfloat16, True),
    (1, 2048, 32, 32, 96, torch.bfloat16, True),
    (1, 200, 8, 2, 64, torch.float32, True),
    (1, 200, 8, 2, 64, torch.float32, False),
    (2, 4096, 24, 8, 64, torch.bfloat16, True),
    (1, 2048, 48, 8, 128, torch.bfloat16, True),
    (1, 4096, 32, 8, 128, torch.bfloat16, True),     # jamba-v0.1-52b
    (2, 4096, 12, 2, 128, torch.bfloat16, True),     # qwen2-vl-2b
])
def test_flash_attention_bwd_kernel_model_shapes(cuda, b, s, h, hkv, d,
                                                 dtype, causal):
    _check_bwd(cuda, b, s, h, hkv, d, dtype, causal)


# The forward at the prefill shapes of jamba-v0.1-52b (32 heads over 8) and
# qwen2-vl-2b (12 over 2: g = 6 over only 2 KV heads), bf16 causal, against
# the plain version at 2e-2 (the bf16 tolerance above).
@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 4096, 32, 8, 128),
                                         (2, 4096, 12, 2, 128)])
def test_flash_attention_kernel_at_new_model_shapes(cuda, b, s, h, hkv, d):
    gen = torch.Generator(cuda).manual_seed(h + hkv)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16) for shape in
               [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)])
    before = fa.launches
    out = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True).float()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    assert not bool(((out.float() - want).abs()
                     > 2e-2 + 2e-2 * want.abs()).any())


# lse: the forward with a pointer writes each row's log-sum-exp (held to the
# plain version's, taken in f32 from f32 products, at 1e-4: f32 sums in
# other orders; the bf16 kernel's exponentials are ex2.approx) and leaves
# its output bit for bit as the call without one.
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 200, 4, 2, 64), (1, 1, 4, 4, 128), (1, 300, 6, 3, 96),
    (1, 130, 4, 4, 256), (2, 4096, 16, 16, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_forward_lse(cuda, b, s, h, hkv, d, dtype, causal):
    q, k, v, _ = _bwd_inputs(cuda, b, s, h, hkv, d, dtype, s + d)
    plain_out, want = ref.flash_attention_ref(q, k, v, causal,
                                              return_lse=True)
    out, lse = fa._forward(q, k, v, causal, True)
    torch.cuda.synchronize()
    assert torch.equal(out, fa._forward(q, k, v, causal, False)[0])
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-4 * float(want.abs().max()),
                               rtol=1e-4)


def test_flash_attention_gradient_through_autograd(cuda):
    """ops.attention on inputs that need a gradient: one forward and one
    backward call, and the gradients autograd gives are the backward
    kernel's."""
    q, k, v, dout = _bwd_inputs(cuda, 2, 130, 8, 2, 64, torch.float32, 5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (fa.launches, fa.bwd_launches)
    out = ops.attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        o, lse = fa._forward(q, k, v, True, True)
        want = fa.flash_attention_bwd(q, k, v, o, lse, dout, True)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-3b"])
def test_chunked_forward_matches_naive_through_the_kernel(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import build_prefill_step, synthetic_batch
    base = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, n_layers=3)
    params = transformer.init(base, torch.Generator(cuda).manual_seed(0),
                              cuda)
    batch = synthetic_batch(base, 0, 2, 200)
    batch.pop("targets")
    logits = {}
    for impl in ["naive", "chunked"]:
        cfg = dataclasses.replace(base, attn_impl=impl)
        step, _ = build_prefill_step(cfg, 2, 200)
        fa.launches = 0
        logits[impl] = step(params, batch)
        torch.cuda.synchronize()
        assert fa.launches == (cfg.n_layers if impl == "chunked" else 0)
    # f32 on both paths, sums in different orders: 1e-3
    torch.testing.assert_close(logits["chunked"], logits["naive"],
                               atol=1e-3, rtol=1e-3)


def _ssd_inputs(gen, b, s, h, p, n, device, dt_range=(0.1, 0.9)):
    x = torch.randn((b, s, h, p), generator=gen, device=device)
    lo, hi = dt_range
    dt = lo + (hi - lo) * torch.rand((b, s, h), generator=gen, device=device)
    a = -(0.5 + torch.rand((h,), generator=gen, device=device))
    bm = torch.randn((b, s, n), generator=gen, device=device)
    cm = torch.randn((b, s, n), generator=gen, device=device)
    return x, dt, a, bm, cm


# tolerance: f32 inputs and outputs, the sums taken in another order and
# the kernel's products in split TF32 (hi.hi + hi.lo + lo.hi, each operand
# split into two TF32 parts), so 1e-4 of the plain output's largest
# magnitude.
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32), (2, 32, 4, 4, 8, 8),
    (2, 256, 8, 16, 16, 16), (1, 512, 4, 64, 128, 128),
    (2, 384, 3, 64, 16, 128), (1, 256, 2, 32, 128, 64), (1, 96, 5, 12, 24, 32),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk,
                                       with_state):
    from repro_torch.kernels import ssd_scan
    gen = torch.Generator(cuda).manual_seed(s * h + p + n)
    args = _ssd_inputs(gen, b, s, h, p, n, cuda)
    init = (torch.randn((b, h, p, n), generator=gen, device=cuda)
            if with_state else None)
    before = ssd_scan.launches
    y, st = ops.ssd(*args, chunk, init)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_st = ref.ssd_chunked_ref(*args, chunk, init)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    assert st.dtype == torch.float32
    for got, want in ((y, want_y), (st, want_st)):
        assert bool(torch.isfinite(got).all())
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
    if s <= 128 and not with_state:        # and the sequential oracle
        seq_y, seq_st = ref.ssd_scan_ref(*args)
        assert float((y - seq_y).abs().max()) <= 1e-4 * float(
            seq_y.abs().max())
        assert float((st - seq_st).abs().max()) <= 1e-4 * float(
            seq_st.abs().max())


def test_ssd_scan_kernel_stays_finite_where_the_decay_overflows(cuda):
    # dA = dt * a reaches about -0.72 a step: cumsum -93 within one
    # 128-step chunk, where exp over the upper triangle is inf in f32.
    gen = torch.Generator(cuda).manual_seed(5)
    x, dt, _, bm, cm = _ssd_inputs(gen, 2, 512, 4, 64, 128, cuda,
                                   dt_range=(0.7, 0.82))
    a = torch.full((4,), -0.95, device=cuda)
    y, st = ops.ssd(x, dt, a, bm, cm, 128)
    want_y, want_st = ref.ssd_chunked_ref(x, dt, a, bm, cm, 128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert float((y - want_y).abs().max()) <= 1e-4 * float(
        want_y.abs().max())


# The shapes the models give the kernel, at full width, against the chunked
# plain version at 1e-4 of its largest magnitude (as above): mamba2-370m's
# prefill; jamba's SSM (N = 16, P = 64); a long memory (small dt, an initial
# state) that state passing carries across all 32 chunks; P = 48, which
# only the chunk-parallel kernel takes.
@pytest.mark.parametrize("b,s,h,p,n,dt_range,with_state", [
    (2, 4096, 32, 64, 128, (0.70, 0.82), False),
    (2, 1024, 8, 64, 16, (0.1, 0.9), False),
    (2, 4096, 4, 64, 128, (0.001, 0.05), True),
    (1, 512, 3, 48, 64, (0.1, 0.9), True),
    (2, 4096, 128, 64, 16, (0.1, 0.9), False),     # jamba's prefill
])
def test_ssd_scan_kernel_at_model_shapes(cuda, b, s, h, p, n, dt_range,
                                         with_state):
    gen = torch.Generator(cuda).manual_seed(s + h + n)
    x, dt, _, bm, cm = _ssd_inputs(gen, b, s, h, p, n, cuda, dt_range)
    a = -(0.9 + 0.1 * torch.rand((h,), generator=gen, device=cuda))
    init = (torch.randn((b, h, p, n), generator=gen, device=cuda)
            if with_state else None)
    y, st = ops.ssd(x, dt, a, bm, cm, 128, init)
    want_y, want_st = ref.ssd_chunked_ref(x, dt, a, bm, cm, 128, init)
    for got, want in ((y, want_y), (st, want_st)):
        assert bool(torch.isfinite(got).all())
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale


def test_ssd_scan_kernel_keeps_no_state_between_calls(cuda):
    # The workspace is new on every call: two calls on other inputs in a
    # row give what the same calls give alone, bit for bit.
    gen = torch.Generator(cuda).manual_seed(11)
    first = _ssd_inputs(gen, 2, 512, 8, 64, 128, cuda)
    second = _ssd_inputs(gen, 2, 512, 8, 64, 128, cuda, (0.001, 0.05))
    init = torch.randn((2, 8, 64, 128), generator=gen, device=cuda)
    y1, st1 = ops.ssd(*first, 128)
    y2, st2 = ops.ssd(*second, 128, init)
    torch.cuda.synchronize()
    y2b, st2b = ops.ssd(*second, 128, init)
    y1b, st1b = ops.ssd(*first, 128)
    for got, want in ((y1b, y1), (st1b, st1), (y2b, y2), (st2b, st2)):
        assert torch.equal(got, want)
    assert not torch.equal(y1, y2)


def test_ssd_scan_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import ssd_scan
    gen = torch.Generator(cuda).manual_seed(0)
    x, dt, a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 16, 16, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan.ssd_scan(x, dt.cpu(), a, bm, cm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dt, a, bm, cm, 16)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x.bfloat16(), dt, a, bm, cm, 16)
    # an input that needs a gradient goes through SSDScan (K4 and K4-bwd)
    y, _ = ssd_scan.ssd_scan(x.clone().requires_grad_(), dt, a, bm, cm, 16)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    with torch.no_grad():      # no graph: the forward alone
        y, _ = ssd_scan.ssd_scan(x.clone().requires_grad_(), dt, a, bm, cm,
                                 16)
    assert y.grad_fn is None
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_scan(x[:, :40].contiguous(), dt[:, :40].contiguous(), a,
                          bm[:, :40].contiguous(), cm[:, :40].contiguous(), 16)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan.ssd_scan(x, dt, a, bm, cm, 24)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan.ssd_scan(x[..., :6].contiguous(), dt, a, bm, cm, 16)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan.ssd_scan(torch.randn((1, 64, 2, 68), device=cuda), dt, a,
                          bm, cm, 16)    # P above 64
    with pytest.raises(ValueError, match="expected"):
        ssd_scan.ssd_scan(x, dt, a[:1].contiguous(), bm, cm, 16)


def test_ssm_forward_goes_through_the_kernel(cuda):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    from repro_torch.train import build_decode_step, build_prefill_step
    cfg = dataclasses.replace(get_config("mamba2-370m", smoke=True),
                              compute_dtype=torch.float32)
    params = ssm.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 48), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    step, _ = build_prefill_step(cfg, 2, 48)
    ssd_scan.launches = 0
    last = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ssd_scan.launches == cfg.n_layers
    # the plain path on the CPU, same weights and tokens: 1e-4 (f32, sums
    # in other orders)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    want = ssm.forward(cpu_params, {"tokens": tokens.cpu()}, cfg)
    torch.testing.assert_close(last.cpu(), want[:, -1], atol=1e-4, rtol=1e-4)
    # decode (plain PyTorch, no kernel) against the kernel's forward
    serve, _ = build_decode_step(cfg, 2, 0)
    cache = ssm.init_cache(cfg, 2)
    full = ssm.forward(params, {"tokens": tokens}, cfg)
    for t in range(48):
        lg, cache = serve(params, cache, np.full((2,), t, np.int32),
                          tokens[:, t:t + 1])
        torch.testing.assert_close(lg[:, 0], full[:, t], atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_chunked_matches_naive_on_the_card(cuda, remat):
    """build_train_step for olmo-1b SMOKE in f32, 3 steps: the chunked
    branch (K3 and K3-bwd) against the naive one (einsum and autograd) from
    the same init and batches.  f32, sums in other orders: the loss to 1e-5
    relative at every step; the grad norm to 1e-4 at the first step, from
    the same params.  After the first update the params differ (AdamW's
    normalised step turns a sign flip of a near-zero gradient into 2·lr),
    and the grad norm follows them: 1e-3 later (on the CPU the gap between
    the two paths grows to a few 1e-4 by the third step).  Params
    to 2·lr·steps at the worst element and 1e-5 at all but a 1e-3 share.
    K3 runs once a layer a step (twice under remat) and K3-bwd once."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   build_train_step, init_state,
                                   synthetic_batch)
    from repro_torch.train.optimizer import tree_leaves
    base = dataclasses.replace(get_config("olmo-1b", smoke=True),
                               compute_dtype=torch.float32, remat=remat)
    lr, steps = 1e-3, 3
    runs = {}
    for impl in ["naive", "chunked"]:
        cfg = dataclasses.replace(base, attn_impl=impl)
        params = transformer.init(cfg, torch.Generator(cuda).manual_seed(0),
                                  cuda)
        tc = TrainConfig(adamw=AdamWConfig(lr=lr))
        step, _ = build_train_step(cfg, 2, 64, tc)
        opt = init_state(params, tc.adamw)
        metrics = []
        for i in range(steps):
            fa.launches = fa.bwd_launches = 0
            params, opt, m = step(params, opt, synthetic_batch(cfg, i, 2, 64))
            torch.cuda.synchronize()
            per_layer = (2 if remat == "full" else 1, 1)
            want = ((cfg.n_layers * per_layer[0], cfg.n_layers * per_layer[1])
                    if impl == "chunked" else (0, 0))
            assert (fa.launches, fa.bwd_launches) == want
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[impl] = (metrics, params)
    (m0, p0), (m1, p1) = runs["naive"], runs["chunked"]
    for i, ((l0, n0), (l1, n1)) in enumerate(zip(m0, m1)):
        assert abs(l1 - l0) <= 1e-5 * abs(l0)
        assert abs(n1 - n0) <= (1e-4 if i == 0 else 1e-3) * n0
    diffs = torch.cat([(a - b).abs().flatten()
                       for a, b in zip(tree_leaves(p1), tree_leaves(p0))])
    assert float(diffs.max()) <= 2 * lr * steps
    assert float((diffs > 1e-5).float().mean()) <= 1e-3


def test_train_step_bf16_chunked_runs_through_both_kernels(cuda):
    """The bf16 training path of the main configuration at SMOKE size:
    finite losses and the K3 / K3-bwd launch counts under remat."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              attn_impl="chunked", remat="full")
    params = transformer.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    step, _ = build_train_step(cfg, 2, 200, TrainConfig())
    opt = init_state(params, TrainConfig().adamw)
    for i in range(2):
        fa.launches = fa.bwd_launches = 0
        params, opt, m = step(params, opt, synthetic_batch(cfg, i, 2, 200))
        torch.cuda.synchronize()
        assert (fa.launches, fa.bwd_launches) == (2 * cfg.n_layers,
                                                  cfg.n_layers)
        assert np.isfinite(float(m["loss"])) and \
            np.isfinite(float(m["grad_norm"]))


SSD_BWD_NAMES = ("dx", "ddt", "da", "dB", "dC", "dinit")


def _ssd_bwd_case(cuda, b, s, h, p, n, chunk, with_state, with_dfinal,
                  dt_range=(0.1, 0.9), a_val=None, seed=0):
    """Inputs, the forward kernel's workspace and K4-bwd's gradients."""
    from repro_torch.kernels import ssd_scan
    gen = torch.Generator(cuda).manual_seed(seed + s * h + p + n)
    x, dt, a, bm, cm = _ssd_inputs(gen, b, s, h, p, n, cuda, dt_range)
    if a_val is not None:
        a = torch.full((h,), a_val, device=cuda)
    init = (torch.randn((b, h, p, n), generator=gen, device=cuda)
            if with_state else None)
    dy = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dfinal = (torch.randn((b, h, p, n), generator=gen, device=cuda)
              if with_dfinal else None)
    args = (x, dt, a, bm, cm, chunk, init)
    _, _, work = ssd_scan._forward(*args)
    before = ssd_scan.bwd_launches
    got = ssd_scan.ssd_scan_bwd(*args, dy, dfinal, work)
    torch.cuda.synchronize()
    assert ssd_scan.bwd_launches == before + 1
    return args, dy, dfinal, work, got


# tolerance: f32 in and out, the products in split TF32 (as K4's forward)
# and the sums in other orders, so 1e-4 of each gradient's largest magnitude
# (measured up to ~2.3e-5).
def _check_ssd_bwd(got, want, tol=1e-4):
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32), (2, 32, 4, 4, 8, 8),
    (2, 256, 8, 16, 16, 16), (1, 512, 4, 64, 128, 128),
    (2, 384, 3, 64, 16, 128), (1, 256, 2, 32, 128, 64), (1, 96, 5, 12, 24, 32),
])
@pytest.mark.parametrize("with_state,with_dfinal", [(False, False),
                                                    (True, True)])
def test_ssd_scan_bwd_kernel_matches_plain(cuda, b, s, h, p, n, chunk,
                                           with_state, with_dfinal):
    args, dy, dfinal, _, got = _ssd_bwd_case(cuda, b, s, h, p, n, chunk,
                                             with_state, with_dfinal)
    _check_ssd_bwd(got, ref.ssd_chunked_bwd_ref(*args, dy, dfinal))


# The shapes the models give it at full width (as K4's model shapes): the
# mamba2-370m training shape with its init-range decay, jamba's SSM (N =
# 16), a long memory carried across all 32 chunks with an initial state and
# dfinal, P = 48; and a decay that overflows exp over the upper triangle.
@pytest.mark.parametrize("b,s,h,p,n,dt_range,a_val,extra", [
    (2, 4096, 32, 64, 128, (0.70, 0.82), -0.95, False),
    (2, 1024, 8, 64, 16, (0.1, 0.9), None, False),
    (2, 4096, 4, 64, 128, (0.001, 0.05), None, True),
    (1, 512, 3, 48, 64, (0.1, 0.9), None, True),
    (2, 512, 4, 64, 128, (0.7, 0.82), -0.95, True),
    (1, 4096, 128, 64, 16, (0.1, 0.9), None, False),   # jamba's training
])
def test_ssd_scan_bwd_kernel_at_model_shapes(cuda, b, s, h, p, n, dt_range,
                                             a_val, extra):
    args, dy, dfinal, _, got = _ssd_bwd_case(
        cuda, b, s, h, p, n, 128, extra, extra, dt_range, a_val)
    _check_ssd_bwd(got, ref.ssd_chunked_bwd_ref(*args, dy, dfinal))


def test_ssd_scan_bwd_kernel_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give the same bits, and a
    call on other inputs in between changes nothing."""
    from repro_torch.kernels import ssd_scan
    args, dy, dfinal, work, got = _ssd_bwd_case(cuda, 2, 1024, 32, 64, 128,
                                                128, True, True)
    other = _ssd_bwd_case(cuda, 2, 1024, 32, 64, 128, 128, False, False,
                          seed=1)[-1]
    again = ssd_scan.ssd_scan_bwd(*args, dy, dfinal, work)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    assert not torch.equal(got[0], other[0])


def test_ssd_scan_gradient_through_autograd(cuda):
    """ops.ssd on CUDA tensors that need a gradient (SSDScan: K4, then
    K4-bwd) against autograd through ref.ssd_chunked_ref on the card, on a
    loss that reads both outputs, at the tolerance above."""
    from repro_torch.kernels import ssd_scan
    gen = torch.Generator(cuda).manual_seed(3)
    x, dt, a, bm, cm = _ssd_inputs(gen, 2, 256, 4, 32, 64, cuda)
    init = torch.randn((2, 4, 32, 64), generator=gen, device=cuda)
    wy = torch.randn((2, 256, 4, 32), generator=gen, device=cuda)
    wf = torch.randn((2, 4, 32, 64), generator=gen, device=cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm,
                                                        init)]
        y, final = fn(*leaves[:5], 64, leaves[5])
        return torch.autograd.grad((y * wy).sum() + (final * wf).sum(),
                                   leaves)

    before = (ssd_scan.launches, ssd_scan.bwd_launches)
    got = grads(ops.ssd)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
    _check_ssd_bwd(got, grads(ref.ssd_chunked_ref))


def test_ssd_scan_bwd_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import ssd_scan
    args, dy, dfinal, work, _ = _ssd_bwd_case(cuda, 1, 64, 2, 16, 16, 16,
                                              True, True)
    with pytest.raises(ValueError, match="workspace"):
        ssd_scan.ssd_scan_bwd(*args, dy, dfinal)
    with pytest.raises(ValueError, match="workspace"):
        ssd_scan.ssd_scan_bwd(*args, dy, dfinal, work[:-1])
    with pytest.raises(ValueError, match="dy"):
        ssd_scan.ssd_scan_bwd(*args, dy[:, :, :1].contiguous(), dfinal, work)
    with pytest.raises(ValueError, match="dfinal"):
        ssd_scan.ssd_scan_bwd(*args, dy, dfinal.double(), work)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan.ssd_scan_bwd(args[0], args[1].cpu(), *args[2:], dy, dfinal,
                              work)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan_bwd(args[0].double(), *args[1:], dy, dfinal, work)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan.ssd_scan_bwd(*args[:5], 24, args[6], dy, dfinal, work)


def _ssd_bwd_kernel_names(call):
    """The names of the ssd_bwd kernels a call launches, from a window of
    three calls: all six or seven, or a window is taken again (see
    _device_kernel_names)."""
    for _ in range(3):
        names = {nm for nm in _device_kernel_names(call, calls=3) if "ssd_bwd" in nm}
        if len(names) >= 6:
            return names
    return names


# K4-bwd's routes (csrc/ssd_scan_bwd.cu): P = 64 at chunk 64 or 128 takes
# the tensor-core route (the state and intra-chunk terms as one wgmma
# launch; dB/dC and the chunk gradients on wgmma where N is 64 or 128);
# every other shape keeps the route of mma.sync.
SSD_BWD_TC = ("ssd_bwd_fused_kernel",)
SSD_BWD_MMA = ("ssd_bwd_state_terms_kernel", "ssd_bwd_intra_kernel")


def test_ssd_scan_bwd_training_shape_runs_the_tensor_core_route(cuda):
    """At mamba2-370m's training shape the profiler shows the fused launch,
    dB/dC and the chunk gradients on wgmma, and none of the kernels they
    replace on the route of mma.sync."""
    from repro_torch.kernels import ssd_scan
    args, dy, dfinal, work, _ = _ssd_bwd_case(cuda, 2, 4096, 32, 64, 128,
                                              128, False, False,
                                              (0.70, 0.82), -0.95)
    bwd = _ssd_bwd_kernel_names(
        lambda: ssd_scan.ssd_scan_bwd(*args, dy, dfinal, work))
    for new in ("ssd_bwd_fused_kernel", "ssd_bwd_dbdc_wgmma_kernel",
                "ssd_bwd_dstate_wgmma_kernel"):
        assert any(new in nm for nm in bwd), (new, bwd)
    for old in SSD_BWD_MMA + ("ssd_bwd_dbdc_kernel", "ssd_bwd_dstate_kernel"):
        assert not any(old in nm for nm in bwd), (old, bwd)


# Shapes of test_ssd_scan_bwd_kernel_matches_plain on each side of the
# route split (and N = 16, whose dB/dC stays on mma.sync).
@pytest.mark.parametrize("b,s,h,p,n,chunk,tc", [
    (1, 512, 4, 64, 128, 128, True), (2, 384, 3, 64, 16, 128, True),
    (1, 256, 2, 64, 128, 64, True), (1, 256, 2, 32, 128, 64, False),
    (2, 64, 3, 8, 16, 16, False), (1, 96, 5, 12, 24, 32, False),
])
def test_ssd_scan_bwd_routes_hold_tolerance_and_repeat(cuda, b, s, h, p, n,
                                                       chunk, tc):
    from repro_torch.kernels import ssd_scan
    args, dy, dfinal, work, got = _ssd_bwd_case(cuda, b, s, h, p, n, chunk,
                                                True, True)
    names = _ssd_bwd_kernel_names(
        lambda: ssd_scan.ssd_scan_bwd(*args, dy, dfinal, work))
    keys = SSD_BWD_TC if tc else SSD_BWD_MMA
    assert all(any(k in nm for nm in names) for k in keys), names
    _check_ssd_bwd(got, ref.ssd_chunked_bwd_ref(*args, dy, dfinal))
    again = ssd_scan.ssd_scan_bwd(*args, dy, dfinal, work)
    for g, g2 in zip(got, again):
        assert (g is None and g2 is None) or torch.equal(g, g2)


def test_mamba2_train_step_runs_through_both_kernels(cuda):
    """build_train_step for mamba2-370m SMOKE in f32 under remat "full", 3
    steps: K4 and the fused conv and gated norm twice a layer a step
    (forward and recompute), K4-bwd and their backward once; and the first
    step's loss and grad norm against the same step with the scan replaced
    by its plain version (autograd through ref.ssd_chunked_ref, which
    ``ops.ssd_mixer`` then runs the whole stretch around plain: no kernel
    counted): f32, sums in other orders, 1e-5 and 1e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    cfg = dataclasses.replace(get_config("mamba2-370m", smoke=True),
                              compute_dtype=torch.float32, remat="full")
    first = {}
    for impl in ["kernel", "plain"]:
        params = ssm.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
        step, _ = build_train_step(cfg, 2, 64, TrainConfig())
        opt = init_state(params, TrainConfig().adamw)
        kernel_ssd = ops.ssd
        if impl == "plain":
            ops.ssd = ref.ssd_chunked_ref
        try:
            for i in range(3 if impl == "kernel" else 1):
                ssd_scan.launches = ssd_scan.bwd_launches = 0
                ssd_fused.launches = ssd_fused.bwd_launches = 0
                ssd_fused.gate_launches = ssd_fused.gate_bwd_launches = 0
                params, opt, m = step(params, opt,
                                      synthetic_batch(cfg, i, 2, 64))
                torch.cuda.synchronize()
                want = ((2 * cfg.n_layers, cfg.n_layers) if impl == "kernel"
                        else (0, 0))
                assert (ssd_scan.launches, ssd_scan.bwd_launches) == want
                assert (ssd_fused.launches, ssd_fused.bwd_launches) == want
                assert (ssd_fused.gate_launches,
                        ssd_fused.gate_bwd_launches) == want
                assert np.isfinite(float(m["loss"])) and \
                    np.isfinite(float(m["grad_norm"]))
                if i == 0:
                    first[impl] = (float(m["loss"]), float(m["grad_norm"]))
        finally:
            ops.ssd = kernel_ssd
    (l1, n1), (l0, n0) = first["kernel"], first["plain"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(n1 - n0) <= 1e-4 * n0


def test_mamba2_train_driver_on_the_card(cuda):
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", "mamba2-370m", "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "32"])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and lines[-1] == "training done" and len(lines) == 4


def test_train_driver_on_the_card(cuda):
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--smoke", "--steps", "3", "--batch", "2",
                         "--seq", "32"])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and lines[-1] == "training done" and len(lines) == 4


@pytest.mark.parametrize("arch,seq", [("olmo-1b", 200), ("mamba2-370m", 64)])
def test_train_step_repeats_bit_for_bit(cuda, arch, seq):
    """Two train steps, each from its own clone of the same params, AdamW
    state and batch, give the same bits in every leaf of params, mu, nu
    and count, and the same loss and grad norm: what a resumed run needs
    to replay an uninterrupted one."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    from repro_torch.train.optimizer import clone_tree
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="chunked")
    tc = TrainConfig()
    params = get_model(cfg).init(cfg, torch.Generator(cuda).manual_seed(0),
                                 cuda)
    step, _ = build_train_step(cfg, 2, seq, tc, cuda)
    opt = init_state(params, tc.adamw)
    # one step first, so that the moments are not zero
    params, opt, _ = step(params, opt, synthetic_batch(cfg, 0, 2, seq))
    batch = synthetic_batch(cfg, 1, 2, seq)
    runs = []
    for _ in range(2):
        p, o, m = step(clone_tree(params), clone_tree(opt), batch)
        runs.append({"params": p, "opt": o, "metrics": m})
    torch.cuda.synchronize()
    (a, b) = (named_leaves(r) for r in runs)
    assert [n for n, _ in a] == [n for n, _ in b] and len(a) > 10
    assert [n for (n, x), (_, y) in zip(a, b) if not torch.equal(x, y)] == []
    assert np.isfinite(float(runs[0]["metrics"]["loss"]))


def test_train_driver_crash_resume_on_the_card(cuda, tmp_path):
    """olmo-1b SMOKE through the train driver on the card: crash after
    step 5, resume, and end with the bits of a run never interrupted."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import train

    def run(*flags):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(["--smoke", "--steps", "8", "--batch", "2",
                             "--seq", "32", "--ckpt-every", "3", *flags])
        return rc, buf.getvalue().splitlines()
    crashed, whole = str(tmp_path / "crashed"), str(tmp_path / "whole")
    rc, lines = run("--ckpt-dir", crashed, "--fail-at", "5")
    assert rc == 42 and lines[-1].startswith("simulated failure")
    rc, resumed = run("--ckpt-dir", crashed, "--resume")
    assert rc == 0 and resumed[0] == "resumed from step 5"
    assert [x.split()[0] for x in resumed[1:3]] == ["step=6", "step=7"]
    assert resumed[3:] == ["training done"]
    rc, full = run("--ckpt-dir", whole)
    assert rc == 0 and len(full) == 9
    assert [x.split()[1] for x in resumed[1:3]] == \
        [x.split()[1] for x in full[6:8]]
    (sa, a), (sb, b) = (CheckpointStore(d, recover=True).restore()
                        for d in (crashed, whole))
    assert sa == sb == 7 and sorted(a) == sorted(b)
    for name in b:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_saves_and_restores_card_tensors(cuda, dtype, tmp_path):
    from repro_torch.checkpoint import (CheckpointConfig, CheckpointStore,
                                        named_leaves)
    gen = torch.Generator(cuda).manual_seed(0)
    tree = {"w": torch.randn((300, 3000), generator=gen, device=cuda)
            .to(dtype),            # ~1.8 or 3.6 MB: more than one chunk
            "b": {"x": torch.randn((7,), generator=gen, device=cuda)
                  .to(dtype)},
            "count": torch.full((), 3, dtype=torch.int32, device=cuda)}
    st = CheckpointStore(str(tmp_path / "ckpt"), CheckpointConfig())
    st.save(4, tree)
    like = {"w": torch.zeros((300, 3000), dtype=dtype, device=cuda),
            "b": {"x": torch.zeros((7,), dtype=dtype, device=cuda)},
            "count": torch.zeros((), dtype=torch.int32, device=cuda)}
    step, got = CheckpointStore(str(tmp_path / "ckpt"),
                                recover=True).restore(like=like)
    assert step == 4 and got is like
    for (name, x), (_, y) in zip(named_leaves(got), named_leaves(tree)):
        assert x.device.type == "cuda" and x.dtype == y.dtype, name
        assert torch.equal(x, y), name


def _granite_moe_layer(cuda, n, dtype, seed):
    """granite-moe-3b-a800m's MoE FFN at full width (d_model 1536, 40
    experts, top 8, ff 512): f32 weights, n tokens and an output gradient
    from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.models import modules
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              compute_dtype=dtype)
    gen = torch.Generator(cuda).manual_seed(seed)
    params = modules.materialize(modules.ffn_specs(cfg), gen, device=cuda)
    x, dy = (torch.randn((1, n, cfg.d_model), generator=gen, device=cuda)
             .to(dtype) for _ in range(2))
    return cfg, params, x, dy


def _moe_layer_grads(params, x, dy, cfg):
    """[y, dx, d router, d wg, d wi, d wo] of one MoE FFN layer."""
    from repro_torch.models import modules
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xr = x.detach().requires_grad_()
    y = modules.moe_ffn(leaves, xr, cfg)
    names = ["router", "wg", "wi", "wo"]
    return [y.detach()] + list(torch.autograd.grad(
        y, [xr] + [leaves[k] for k in names], dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_repeats_bit_for_bit(cuda, dtype):
    """Forward and backward of the MoE FFN twice on the same inputs give
    the same bits: the combine and the dispatch's gradient add each
    token's pairs in a fixed order, by gathers, with no atomics."""
    cfg, params, x, dy = _granite_moe_layer(cuda, 4096, dtype, 0)
    runs = [_moe_layer_grads(params, x, dy, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_moe_layer_matches_the_host(cuda):
    """The MoE FFN at full width in f32 on the card against the same
    function on the host CPU: y, dx and the four weights' gradients, each
    at 1e-4 of its largest magnitude (sums in other orders).  A token
    whose kept experts differ between the two (a near-tie) gets no output
    gradient on either side and its rows are not compared; at most 1 of
    the 1024 may."""
    from repro_torch.models import modules
    cfg, params, x, dy = _granite_moe_layer(cuda, 1024, torch.float32, 1)
    host = {k: v.cpu() for k, v in params.items()}
    kept = []
    for p, xs in ((params, x), (host, x.cpu())):
        plan = modules.moe_route((xs[0] @ p["router"]).float(), cfg)
        k = torch.zeros((1024, cfg.n_experts), dtype=torch.bool)
        k[plan["tok"].cpu(), plan["idx"].reshape(-1)[plan["order"]].cpu()] = \
            plan["keep"].cpu()
        kept.append(k)
    same = ~(kept[0] != kept[1]).any(1)
    assert int((~same).sum()) <= 1
    dy = dy * same.to(cuda)[None, :, None]
    got = _moe_layer_grads(params, x, dy, cfg)
    want = _moe_layer_grads(host, x.cpu(), dy.cpu(), cfg)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        if i < 2:                     # y and dx: the tokens routed alike
            g, w = g[0, same], w[0, same]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale, i


def test_moe_train_step_repeats_bit_for_bit(cuda):
    """A granite-moe-3b-a800m train step at full width, 2 layers, chunked
    attention (K3 and K3-bwd), taken twice from clones of one state (after
    one step, so the moments are not zero), gives the same bits in every
    leaf and in the loss and grad norm."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    from repro_torch.train.optimizer import clone_tree
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              n_layers=2, attn_impl="chunked")
    tc = TrainConfig()
    params = get_model(cfg).init(cfg, torch.Generator(cuda).manual_seed(0),
                                 cuda)
    step, _ = build_train_step(cfg, 2, 512, tc, cuda)
    opt = init_state(params, tc.adamw)
    params, opt, _ = step(params, opt, synthetic_batch(cfg, 0, 2, 512))
    batch = synthetic_batch(cfg, 1, 2, 512)
    runs = []
    for _ in range(2):
        p, o, m = step(clone_tree(params), clone_tree(opt), batch)
        runs.append(named_leaves({"params": p, "opt": o, "metrics": m}))
    torch.cuda.synchronize()
    assert [n for n, _ in runs[0]] == [n for n, _ in runs[1]]
    assert [n for (n, x), (_, y) in zip(*runs) if not torch.equal(x, y)] \
        == []
    assert np.isfinite(float(dict(runs[0])["metrics/loss"]))


def test_hybrid_train_step_runs_through_the_kernels(cuda):
    """build_train_step for jamba-v0.1-52b SMOKE in f32 under remat "full",
    3 steps: a step launches K3 twice and K3-bwd once for the attention
    position, K4 twice and K4-bwd once for each of the 7 Mamba positions;
    the first step's loss and grad norm against the same step with both
    replaced by their plain versions (naive attention, autograd through
    ref.ssd_chunked_ref): 1e-5 relative for the loss, 1e-2 for the grad
    norm, which F7's std-1 weights leave ill conditioned
    (tests/test_torch_train.py's jamba case says why)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import hybrid
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    base = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True),
                               compute_dtype=torch.float32, remat="full")
    first = {}
    for impl in ["kernel", "plain"]:
        cfg = dataclasses.replace(
            base, attn_impl="chunked" if impl == "kernel" else "naive")
        params = hybrid.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
        step, _ = build_train_step(cfg, 2, 64, TrainConfig())
        opt = init_state(params, TrainConfig().adamw)
        kernel_ssd = ops.ssd
        if impl == "plain":
            ops.ssd = ref.ssd_chunked_ref
        try:
            for i in range(3 if impl == "kernel" else 1):
                fa.launches = fa.bwd_launches = 0
                ssd_scan.launches = ssd_scan.bwd_launches = 0
                params, opt, m = step(params, opt,
                                      synthetic_batch(cfg, i, 2, 64))
                torch.cuda.synchronize()
                got = (fa.launches, fa.bwd_launches, ssd_scan.launches,
                       ssd_scan.bwd_launches)
                assert got == ((2, 1, 14, 7) if impl == "kernel"
                               else (0, 0, 0, 0))
                assert np.isfinite(float(m["loss"])) and \
                    np.isfinite(float(m["grad_norm"]))
                if i == 0:
                    first[impl] = (float(m["loss"]), float(m["grad_norm"]))
        finally:
            ops.ssd = kernel_ssd
    (l1, n1), (l0, n0) = first["kernel"], first["plain"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(n1 - n0) <= 1e-2 * n0


def test_hybrid_train_step_at_full_width_repeats_bit_for_bit(cuda):
    """A jamba-v0.1-52b train step at full width, cut to one super-block
    (8 of 32 layers) and 2 of 16 experts (3.40B params), batch 1, seq 256,
    bf16 compute, remat "full", taken twice from one state (after one
    step, so that the moments are not zero).  The state (params, mu, nu:
    40.8 GB) fits the card once, not twice, so the state before the step
    is kept on the host and put back for the second run, and the first
    run's results are kept on the host to compare: every leaf, the loss
    and the grad norm bit for bit."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8,
                              n_experts=2, attn_impl="chunked")
    tc = TrainConfig()
    params = hybrid.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    step, _ = build_train_step(cfg, 1, 256, tc, cuda)
    opt = init_state(params, tc.adamw)
    params, opt, _ = step(params, opt, synthetic_batch(cfg, 0, 1, 256))
    batch = synthetic_batch(cfg, 1, 1, 256)
    state = [x for _, x in named_leaves({"params": params, "opt": opt})]
    host = [x.to("cpu", copy=True) for x in state]
    _, _, m1 = step(params, opt, batch)
    # leaf by leaf: the first run's result to the host, the state before
    # it back to the card (one copy of the state on the host at a time)
    for i, x in enumerate(state):
        first = x.to("cpu", copy=True)
        x.copy_(host[i])
        host[i] = first
    fa.launches = 0
    _, _, m2 = step(params, opt, batch)
    torch.cuda.synchronize()
    assert fa.launches == 2
    assert [i for i, (x, h) in enumerate(zip(state, host))
            if not torch.equal(x.cpu(), h)] == []
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    assert np.isfinite(float(m1["loss"]))


# ---------------------------------------------------------------------------
# The mesh and the parallel modules on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat,fwd_per_layer", [
    ("dots_with_no_batch_dims", 2), ("full", 2), ("none", 1)])
def test_remat_policy_train_step_on_the_host_mesh(cuda, remat,
                                                  fwd_per_layer):
    """olmo-1b at full width (seq cut to 512) through build_train_step on
    make_host_mesh(): K3 runs again in the backward pass under both
    checkpointing policies (no dispatch mode sees its launch), K3-bwd once
    a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.train import (TrainConfig, build_train_step,
                                   init_state, synthetic_batch)
    cfg = dataclasses.replace(get_config("olmo-1b"), attn_impl="chunked",
                              remat=remat)
    mesh = make_host_mesh()
    assert mesh.device_type == "cuda" and mesh.devices.size >= 1
    params = get_model(cfg).init(cfg, torch.Generator(cuda).manual_seed(0),
                                 cuda)
    tc = TrainConfig()
    step, _ = build_train_step(cfg, 1, 512, tc, cuda, mesh=mesh)
    opt = init_state(params, tc.adamw)
    before = fa.launches, fa.bwd_launches
    _, _, m = step(params, opt, synthetic_batch(cfg, 0, 1, 512))
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.bwd_launches - before[1]) == \
        (fwd_per_layer * cfg.n_layers, cfg.n_layers)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


def test_remat_policies_give_the_same_gradient_bits(cuda):
    """One f32 loss and gradient of olmo-1b at full width cut to 2 layers
    (K3 and K3-bwd in f32) under each remat policy: the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import synthetic_batch
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    base = dataclasses.replace(get_config("olmo-1b"), n_layers=2,
                               compute_dtype=torch.float32,
                               attn_impl="chunked")
    params = get_model(base).init(base, torch.Generator(cuda).manual_seed(0),
                                  cuda)
    batch = {k: torch.as_tensor(v, device=cuda)
             for k, v in synthetic_batch(base, 0, 2, 256).items()}
    runs = []
    for remat in ["none", "full", "dots_with_no_batch_dims"]:
        cfg = dataclasses.replace(base, remat=remat)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = get_model(cfg).loss_fn(tree_unflatten(params, leaves), batch,
                                      cfg)
        runs.append((loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
    (l0, g0), *rest = runs
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(a, b) for a, b in zip(grads, g0))


def test_int8_allreduce_in_a_world_size_1_nccl_group(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.parallel import int8_allreduce, int8_quantize
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        x = torch.randn(2048, 8192, generator=torch.Generator(cuda)
                        .manual_seed(3), device=cuda) * 1e-3
        got = int8_allreduce(x)
        q, scale = int8_quantize(x)
        cpu_group = dist.new_group([0], backend="gloo")
        host = int8_allreduce(x.cpu(), group=cpu_group)
        torch.cuda.synchronize()
        assert torch.equal(got, q.to(torch.int32).float() * (scale / 1))
        assert torch.equal(got.cpu(), host)
    finally:
        dist.destroy_process_group()


def test_torch_serve_example_on_the_card(cuda):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "examples/torch_serve_paged.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ,
                                               PYTHONPATH=str(root / "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == (
        "completed=16 decode_steps=34 compactions=7 compaction_dmas=248 "
        "fragmentation=0.000")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("h,p,n,chunk,split", [
    (8, 16, 16, 16, False), (32, 64, 128, 128, False),
    (128, 64, 16, 128, False), (8, 64, 128, 128, True)])
def test_ssd_fused_stretch_matches_its_plain_composite(cuda, h, p, n, chunk,
                                                       split, dtype, tol):
    """ssd_fused.ssd_mixer (the fused kernels around K4 and K4-bwd) against
    ssd_mixer_ref (the plain composite around the same K4 and K4-bwd) on
    the card: the output, the final state and the gradients of the packed
    projection and the five parameters, at mamba2's SMOKE and full widths
    and jamba's, and with the heads split (no norm).  Tolerance of the
    largest magnitude: 1e-4 in f32 (sums in other orders, FMA), 5e-2 in
    bf16 (the plain composite rounds each product, partial sum and the
    gate to bf16, the kernels once).  Each kernel's counter counts one
    call (the gated norm's none with the heads split)."""
    rng = np.random.default_rng(h + n)
    b, s, di, c = 2, 256, h * p, h * p + 2 * n
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(cuda)
    leaves = [f(b, s, di + c + h).to(dtype), 0.5 * f(4, c),
              torch.from_numpy(rng.uniform(-4, -2, h).astype(np.float32))
              .to(cuda),
              torch.from_numpy(np.log(rng.uniform(1, 16, h))
                               .astype(np.float32)).to(cuda),
              1 + 0.1 * f(h), 1 + 0.1 * f(di)]
    widths = ssd_fused.Widths(h, p, n, chunk)
    res = []
    for mixer in (ssd_fused.ssd_mixer, ssd_fused.ssd_mixer_ref):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        counters = ("launches", "bwd_launches", "gate_launches",
                    "gate_bwd_launches")
        before = [getattr(ssd_fused, c) for c in counters]
        out, state = mixer(*xs[:5], None if split else xs[5], None, widths)
        g = torch.randn(out.shape, generator=torch.Generator(cuda)
                        .manual_seed(1), device=cuda).to(out.dtype)
        grads = torch.autograd.grad([out, state],
                                    xs[:5] + ([] if split else xs[5:]),
                                    [g, torch.ones_like(state)])
        torch.cuda.synchronize()
        calls = [getattr(ssd_fused, c) - n for c, n in zip(counters, before)]
        gate = 0 if split else 1
        assert calls == ([1, 1, gate, gate] if mixer is ssd_fused.ssd_mixer
                         else [0, 0, 0, 0])
        res.append([out, state, *grads])
    for i, (got, want) in enumerate(zip(*res)):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert torch.isfinite(got).all() and err <= tol * scale, (i, err,
                                                                  scale)
