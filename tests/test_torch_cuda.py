"""The hand-written kernels against their plain versions, on the card.

Skipped on a machine with no card.  On one:
  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.kernels import gc_compact, ops, ref
from repro_torch.kernels import paged_attention as pa

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
    assert gc_compact.launches - before <= 2
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
    assert 0 < gc_compact.launches <= 24
