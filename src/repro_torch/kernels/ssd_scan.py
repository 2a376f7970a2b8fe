"""SSD scan: the wrapper of ``csrc/ssd_scan.cu``.

The Mamba-2 chunked scan, in place of the Pallas TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_scan``: per chunk the intra-chunk term,
the carried state's term and the state update.  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor runs the plain version,
``ref.ssd_chunked_ref``.  One call is three launches, chunk-parallel except
for the state passing: (1) each chunk's own (P, N) state, (2) the states
carried into each chunk, walked in order elementwise, (3) each chunk's y from
C.B^T (taken once for a group of heads) and the carried state.  Their
products run on the tensor cores in split TF32 (hi.hi + hi.lo + lo.hi of
each operand's two TF32 parts): one TF32 rounding, 2^-11 of each operand, is
above the 1e-4 that the f32 results are held to.  Bound on an H100: the
decomposition's bytes (~480 MB at mamba2-370m's prefill, ~0.145 ms), above
its operations (3 x 8.59 GFLOP at the TF32 peak, ~0.052 ms).  The wrapper
allocates the workspace, each chunk's state (B, H, S/chunk, P, N) and its
sum of dA, anew on every call (67 MB at that prefill).  The kernel takes
float32 only (``ssd_layer`` always feeds it f32) and has no backward: the
wrapper refuses inputs that would need a gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _shapes_ok(p: int, n: int, chunk: int) -> bool:
    # rows are copied 16 bytes at a time; one chunk's x, B, C and entering
    # state fit one CTA's shared memory up to P = 64, N = 128, chunk 128
    p_ok = 4 <= p <= 64 and p % 4 == 0
    n_ok = 8 <= n <= 128 and n % 8 == 0
    return p_ok and n_ok and chunk in (8, 16, 32, 64, 128)


def ssd_scan(x, dt, a, bmat, cmat, chunk: int, initial_state=None):
    """x: (B, S, H, P); dt: (B, S, H); a: (H,) < 0; bmat/cmat: (B, S, N);
    initial_state: (B, H, P, N) or None (zeros); S % chunk == 0.  Returns
    (y: (B, S, H, P) in x's dtype, final_state: (B, H, P, N) float32).

    On the card: all float32, P a multiple of 4 in [4, 64], N a multiple of
    8 in [8, 128], chunk a power of two in [8, 128]."""
    tensors = [x, dt, a, bmat, cmat]
    if initial_state is not None:
        tensors.append(initial_state)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.ssd_chunked_ref(x, dt, a, bmat, cmat, chunk, initial_state)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("ssd_scan: all tensors must be on one CUDA device, "
                         "or all on the CPU")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssd_scan: the kernel has no backward; call it "
                           "under torch.no_grad() or on inputs that do not "
                           "require grad")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1] if bmat.dim() == 3 else 0
    want = {"dt": (b, s, h), "a": (h,), "bmat": (b, s, n), "cmat": (b, s, n),
            "initial_state": (b, h, p, n)}
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if not _shapes_ok(p, n, chunk):
        raise ValueError(f"ssd_scan: unsupported P={p}, N={n}, chunk={chunk}")
    if s % chunk:
        raise ValueError(f"ssd_scan: seq {s} is not a multiple of chunk "
                         f"{chunk}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_scan: the kernel takes float32 inputs only")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ssd_scan: inputs must be contiguous and "
                             "16-byte aligned")
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # each chunk's state (B, H, S/chunk, P, N), then its sum of dA
    nc = s // chunk
    workspace = torch.empty(b * h * nc * (p * n + 1), dtype=torch.float32,
                            device=x.device)
    err = _lib().ssd_scan(
        *(t.data_ptr() for t in (x, dt, a, bmat, cmat)),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), workspace.data_ptr(), b, s, h, p, n,
        chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    global launches
    launches += 1
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    return y, final
