"""SSD scan: the wrappers of ``csrc/ssd_scan.cu`` (forward) and
``csrc/ssd_scan_bwd.cu`` (backward).

The Mamba-2 chunked scan, in place of the Pallas TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_scan``: per chunk the intra-chunk term,
the carried state's term and the state update.  A CUDA tensor launches the
hand-written kernels (or raises); a CPU tensor runs the plain versions,
``ref.ssd_chunked_ref`` and ``ref.ssd_chunked_bwd_ref``; a meta tensor
does no work: it returns empty outputs (and workspace) of the kernels'
shapes and adds their least work (``cost.py``) to the active cost
counter.  The forward is
three launches, chunk-parallel except for the state passing: (1) each
chunk's own (P, N) state, (2) the states carried into each chunk, walked in
order elementwise, (3) each chunk's y from C.B^T (taken once for a group of
heads) and the carried state.  Their products run on the tensor cores in
split TF32 (hi.hi + hi.lo + lo.hi of each operand's two TF32 parts): one
TF32 rounding, 2^-11 of each operand, is above the 1e-4 that the f32
results are held to.  Bound on an H100: the decomposition's bytes (~480 MB
at mamba2-370m's prefill, ~0.145 ms), above its operations (3 x 8.59 GFLOP
at the TF32 peak, ~0.052 ms).  The wrapper allocates the workspace, the
state entering each chunk (B, H, S/chunk, P, N) and each chunk's sum of dA,
anew on every call (67 MB at that prefill).

Where a gradient is wanted the call goes through ``SSDScan``, a
``torch.autograd.Function``: its forward keeps the workspace, and its
backward is the backward kernel, which takes the states entering each
chunk from it instead of computing them again.  The backward has two
routes, chosen in the kernel by shape: P = 64 at chunk 64 or 128
(mamba2-370m, jamba) runs its state and intra-chunk terms as one launch and
dB/dC (N 64 or 128) on ``wgmma`` in split TF32; every other shape keeps the
products on ``mma.sync``.  Both kernels take float32 only (``ssd_layer``
always feeds them f32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, cost, ref

# Kernel calls since the last reset; chip_smoke.py reads them.  ``launches``
# counts forward calls (three launches each), ``bwd_launches`` backward
# calls (six launches each where P = 64 at chunk 64 or 128, the tensor-core
# route; seven on the route of mma.sync).
launches = 0
bwd_launches = 0


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        work = lib.ssd_scan_bwd_workspace
        work.argtypes = [ctypes.c_int] * 6
        work.restype = ctypes.c_longlong
    return lib


def _shapes_ok(p: int, n: int, chunk: int) -> bool:
    # rows are copied 16 bytes at a time; one chunk's x, B, C and entering
    # state fit one CTA's shared memory up to P = 64, N = 128, chunk 128
    p_ok = 4 <= p <= 64 and p % 4 == 0
    n_ok = 8 <= n <= 128 and n % 8 == 0
    return p_ok and n_ok and chunk in (8, 16, 32, 64, 128)


def _check(tensors, chunk: int, what: str = "ssd_scan"):
    """(B, S, H, P, N) of the scan's inputs (x, dt, a, bmat, cmat, then
    initial_state where given); raises unless every tensor lies on one CUDA
    device (or all on meta) and has the kernels' shape, dtype and
    layout."""
    x = tensors[0]
    if any(t.device != x.device for t in tensors) \
            or x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: all tensors must be on one CUDA device, "
                         "or all on the CPU, or all on meta")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = tensors[3].shape[-1] if tensors[3].dim() == 3 else 0
    want = {"dt": (b, s, h), "a": (h,), "bmat": (b, s, n), "cmat": (b, s, n),
            "initial_state": (b, h, p, n)}
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if not _shapes_ok(p, n, chunk):
        raise ValueError(f"{what}: unsupported P={p}, N={n}, chunk={chunk}")
    if s % chunk:
        raise ValueError(f"{what}: seq {s} is not a multiple of chunk "
                         f"{chunk}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: the kernel takes float32 inputs only")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             "16-byte aligned")
    return b, s, h, p, n


def _forward(x, dt, a, bmat, cmat, chunk: int, initial_state=None):
    """(y, final_state, workspace): the workspace holds the state entering
    each chunk (B, H, S/chunk, P, N), then each chunk's sum of dA
    (B, H, S/chunk); None for CPU tensors."""
    tensors = [x, dt, a, bmat, cmat]
    if initial_state is not None:
        tensors.append(initial_state)
    if all(t.device.type == "cpu" for t in tensors):
        return (*ref.ssd_chunked_ref(x, dt, a, bmat, cmat, chunk,
                                     initial_state), None)
    b, s, h, p, n = _check(tensors, chunk)
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    nc = s // chunk
    workspace = torch.empty(b * h * nc * (p * n + 1), dtype=torch.float32,
                            device=x.device)
    if x.device.type == "meta":
        cost.add("ssd_scan", *cost.ssd_flops_bytes(
            b, s, h, p, n, initial_state is not None))
        return y, final, workspace
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
    return y, final, workspace


def ssd_scan_bwd(x, dt, a, bmat, cmat, chunk: int, initial_state, dy,
                 dfinal=None, workspace=None):
    """The gradients (dx, ddt, da, dB, dC, dinit) of ``ssd_scan`` at its
    inputs, given y's gradient ``dy`` (x's shape) and the final state's
    ``dfinal`` ((B, H, P, N), None for zeros); dinit is None when
    ``initial_state`` is None.  CPU tensors run ``ref.ssd_chunked_bwd_ref``;
    meta tensors give empty gradients and add the kernel's least work to the
    cost counter.  CUDA tensors run the backward kernel, which reads the
    states entering each chunk from the forward kernel's ``workspace`` (as
    ``_forward`` returns it for the same inputs)."""
    tensors = [x, dt, a, bmat, cmat]
    if initial_state is not None:
        tensors.append(initial_state)
    grads = [dy] + ([] if dfinal is None else [dfinal])
    if all(t.device.type == "cpu" for t in tensors + grads):
        return ref.ssd_chunked_bwd_ref(x, dt, a, bmat, cmat, chunk,
                                       initial_state, dy, dfinal)
    b, s, h, p, n = _check(tensors, chunk, "ssd_scan_bwd")
    nc = s // chunk
    if workspace is None or workspace.device != x.device \
            or workspace.dtype != torch.float32 \
            or workspace.numel() != b * h * nc * (p * n + 1):
        raise ValueError("ssd_scan_bwd: needs the forward's workspace of "
                         f"{b * h * nc * (p * n + 1)} float32 on {x.device}")
    for name, t, shape in (("dy", dy, (b, s, h, p)),
                           ("dfinal", dfinal, (b, h, p, n))):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"ssd_scan_bwd: {name} must be a contiguous, "
                             f"16-byte aligned float32 {shape} on "
                             f"{x.device}")
    dx, dbm, dc = (torch.empty_like(t) for t in (x, bmat, cmat))
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a)
    dinit = None if initial_state is None else torch.empty_like(initial_state)
    if x.device.type == "meta":
        cost.add("ssd_scan_bwd", *cost.ssd_bwd_flops_bytes(
            b, s, h, p, n, chunk, initial_state is not None,
            dfinal is not None))
        return dx, ddt, da, dbm, dc, dinit
    lib = _bwd_lib()
    work = torch.empty(
        (lib.ssd_scan_bwd_workspace(b, s, h, p, n, chunk),),
        dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_bwd(
        *(t.data_ptr() for t in (x, dt, a, bmat, cmat, dy)),
        None if dfinal is None else dfinal.data_ptr(), workspace.data_ptr(),
        *(t.data_ptr() for t in (dx, ddt, da, dbm, dc)),
        None if dinit is None else dinit.data_ptr(), work.data_ptr(),
        b, s, h, p, n, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    global bwd_launches
    bwd_launches += 1
    if err:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError "
                           f"{err}")
    return dx, ddt, da, dbm, dc, dinit


class SSDScan(torch.autograd.Function):
    """K4 with its gradient: the forward kernel, keeping its workspace only
    when a gradient is asked for, and the backward kernel.  a's gradient
    goes back to a = -exp(a_log) and autograd carries it on.  Under
    non-reentrant checkpointing the forward runs again in the backward
    pass, and saves its workspace then."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk, initial_state):
        y, final, workspace = _forward(x, dt, a, bmat, cmat, chunk,
                                       initial_state)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, dt, a, bmat, cmat, initial_state,
                                  workspace)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, bmat, cmat, initial_state, workspace = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        dx, ddt, da, dbm, dc, dinit = ssd_scan_bwd(
            x, dt, a, bmat, cmat, ctx.chunk, initial_state, dy, dfinal,
            workspace)
        return dx, ddt, da, dbm, dc, None, dinit


def ssd_scan(x, dt, a, bmat, cmat, chunk: int, initial_state=None):
    """x: (B, S, H, P); dt: (B, S, H); a: (H,) < 0; bmat/cmat: (B, S, N);
    initial_state: (B, H, P, N) or None (zeros); S % chunk == 0.  Returns
    (y: (B, S, H, P) in x's dtype, final_state: (B, H, P, N) float32).

    On the card: all float32, P a multiple of 4 in [4, 64], N a multiple of
    8 in [8, 128], chunk a power of two in [8, 128].  Differentiable: with
    grad enabled and an input that requires it, the call goes through
    ``SSDScan``; otherwise the forward kernel alone runs."""
    tensors = [x, dt, a, bmat, cmat]
    if initial_state is not None:
        tensors.append(initial_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return SSDScan.apply(x, dt, a, bmat, cmat, chunk, initial_state)
    return _forward(x, dt, a, bmat, cmat, chunk, initial_state)[:2]
