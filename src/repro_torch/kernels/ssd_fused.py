"""The Mamba-2 SSD layer between its two projections, fused around K4:
the wrappers of ``csrc/ssd_fused.cu`` and ``SSDMixer``.

``ssd_mixer`` takes the packed in-projection output ``proj`` (z | xBC | dt
columns, in the compute dtype) and gives the input of the out-projection:
the depthwise causal conv and SiLU of xBC, softplus(dt + dt_bias), the SSD
scan (K4), the D skip, the gate by silu(z) and the gated RMS norm.  Where
a gradient is wanted it goes through ``SSDMixer``, a
``torch.autograd.Function`` whose backward runs the same stretch's
gradient around K4-bwd and returns one gradient of ``proj``: the
kernels write the z, xBC and dt columns' gradients straight into it, so
no slice of ``proj`` reaches autograd and none is zero-filled.

Two kernel pairs run on the card (``csrc/ssd_fused.cu`` says what each
fuses and its bound): ``conv_fwd`` (the conv, SiLU and the dt softplus,
writing x, B and C in f32 as K4 reads them) and ``gate_fwd`` (the D
skip, the gate and the norm); ``gate_bwd`` and ``conv_bwd`` in the
backward.  Each wrapper runs its plain version (``*_ref`` below, the
unfused PyTorch of ``models/ssm.py`` before these kernels) for CPU
tensors, launches its kernel for CUDA tensors (or raises) and counts the
launch, and for meta tensors returns empty outputs of the kernel's shapes
and adds its least work (``cost.py``) to the active cost counter.  A plain backward is
autograd through its plain forward.

Precision: the conv accumulates in f32 from the weights rounded to the
compute dtype and rounds its output once to the compute dtype (the plain
version rounds each product and partial sum); the D skip, the gate and
the norm stay in f32 to the store (the plain version rounds y + D x and
the gate to the compute dtype).  K4 and K4-bwd get f32 operands as
before.

The norm over the whole row needs the row on one process.  Under a step
that splits the Mamba-2 heads over a ``model`` axis of more than one
process each holds its heads' channels, and the sum of squares must be
added up over processes (``runtime.psum``) before any channel is scaled:
``ssm.ssd_layer`` then passes no ``out_norm``, and ``ssd_mixer`` returns
y + D x (f32) for the caller's composite norm, with the conv kernels still
fused (they are per channel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build, cost, ssd_scan

# Launches since the last reset, each counted by its wrapper once the
# launch succeeded; the benchmark and chip_smoke.py read them.
# ``launches`` / ``bwd_launches``: the conv and dt pair, forward and
# backward; ``gate_launches`` / ``gate_bwd_launches``: the gated norm's
# (none with the heads split over processes, where the norm is the
# caller's).
launches = 0
bwd_launches = 0
gate_launches = 0
gate_bwd_launches = 0

EPS = 1e-6            # the gated norm's, as ``modules.rmsnorm``'s default
CONV_GROUP = 8        # channels the kernels take at a time (16 bytes bf16)
CONV_WIDTH = 4        # the conv kernels' taps (``models/ssm.py``: D_CONV)
GATE_MAX = 8192       # the widest row a gated-norm CTA holds
DT_CTAS = 256         # CTAs of the dt gradient (each one partial)


class Widths(NamedTuple):
    """This process's heads of the layer: ``heads`` × ``headdim`` z and x
    channels, B and C of ``state`` each, and the scan's ``chunk``."""
    heads: int
    headdim: int
    state: int
    chunk: int


def _lib():
    lib = _build.load("ssd_fused")
    if lib.ssd_conv_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_conv_fwd.argtypes = [p, p, ll] + [p] * 8 + [i] * 7 + [p]
        lib.ssd_conv_bwd.argtypes = ([p, p, ll] + [p] * 12 + [ll] + [p] * 4
                                     + [i] * 9 + [p])
        lib.ssd_conv_bwd_scratch.argtypes = [i] * 5
        lib.ssd_conv_bwd_scratch.restype = ll
        lib.ssd_gate_fwd.argtypes = ([p, p, p, ll] + [p] * 4
                                     + [ll, i, i, ctypes.c_float, i, i, p])
        lib.ssd_gate_bwd.argtypes = ([p, p, p, p, ll] + [p] * 4 + [p, ll]
                                     + [p] * 3 + [ll, i, i, i, i, p])
        lib.ssd_gate_bwd_scratch.argtypes = [i] * 3
        lib.ssd_gate_bwd_scratch.restype = ll
        for fn in (lib.ssd_conv_fwd, lib.ssd_conv_bwd, lib.ssd_gate_fwd,
                   lib.ssd_gate_bwd):
            fn.restype = ctypes.c_int
    return lib


def _raise(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def causal_conv_ref(xbc, conv_w):
    """Depthwise causal conv along seq, then SiLU: xbc (B, S, C), conv_w
    (K, C) in xbc's dtype, each product and partial sum in that dtype."""
    k = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i][None, None, :]
              for i in range(k))
    return F.silu(out)


def conv_fwd_ref(xbc, conv_w, dx: int, n: int):
    """(x (B, S, dx), B (B, S, n), C (B, S, n)), f32: the conv of xbc with
    conv_w cast to xbc's dtype, split."""
    out = causal_conv_ref(xbc, conv_w.to(xbc.dtype))
    return (out[..., :dx].float().contiguous(),
            out[..., dx:dx + n].float().contiguous(),
            out[..., dx + n:].float().contiguous())


def dt_fwd_ref(dt, dt_bias, a_log):
    """softplus(dt + dt_bias) and a = -exp(a_log), in f32."""
    return F.softplus(dt.float() + dt_bias.float()), -torch.exp(a_log.float())


def skip_ref(y, x, d_skip):
    """y + D x: y, x (B, S, H, P) f32, D (H,)."""
    return y + d_skip.float()[None, None, :, None] * x


def gate_fwd_ref(y, x, z, d_skip, gamma):
    """(out, rstd): rmsnorm((y + D x) · silu(z)) · gamma, y + D x cast to
    z's dtype and gated there, the norm in f32 and cast back; rstd (B, S)
    f32 the norm's 1/rms.  y, x (B, S, H, P) f32; z (B, S, H·P)."""
    b, s, h, p = y.shape
    g = skip_ref(y, x, d_skip).reshape(b, s, h * p).to(z.dtype) * F.silu(z)
    g32 = g.float()
    rstd = torch.rsqrt((g32 * g32).mean(-1, keepdim=True) + EPS)
    return (g32 * rstd * gamma).to(g.dtype), rstd[..., 0]


def _grads(fn, inputs, wanted, grads_out):
    """Gradients of ``fn(*inputs)``'s outputs, given ``grads_out``, at the
    inputs whose index is in ``wanted``: autograd through a plain
    forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if i in wanted else t
                  for i, t in enumerate(inputs)]
        outs = fn(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   [leaves[i] for i in wanted],
                                   [g for _, g in pairs])


def gate_bwd_ref(dout, y, x, z, d_skip, gamma):
    """(dy, dz, d_skip's gradient, gamma's) of ``gate_fwd_ref``'s out."""
    return _grads(lambda *a: gate_fwd_ref(*a)[:1],
                  (y, x, z, d_skip, gamma), (0, 2, 3, 4), (dout,))


def conv_bwd_ref(xbc, conv_w, dx_scan, dy, d_skip, dbm, dcm):
    """(d xbc, d conv_w) of ``conv_fwd_ref``, given K4-bwd's dx, dB and dC,
    and dy, the gradient of y + D x (B, S, H, P), whose D x term reaches x
    too."""
    b, s, h, p = dx_scan.shape
    n = dbm.shape[-1]
    dx = (dx_scan + dy * d_skip.float()[None, None, :, None]).reshape(
        b, s, h * p)
    return _grads(lambda *a: conv_fwd_ref(*a, h * p, n), (xbc, conv_w),
                  (0, 1), (dx, dbm, dcm))


def dt_bwd_ref(ddt, da, dt, dt_bias, a_log):
    """(d dt, d dt_bias, d a_log) of ``dt_fwd_ref``."""
    return _grads(dt_fwd_ref, (dt, dt_bias, a_log), (0, 1, 2), (ddt, da))


def ssd_mixer_ref(proj, conv_w, dt_bias, a_log, d_skip, out_norm,
                  initial_state, widths: Widths):
    """``ssd_mixer`` unfused, differentiable by autograd, on any device:
    the plain versions in order around ``ops.ssd``, looked up when called.
    ``ops.ssd_mixer`` runs this where a run has set ``ops.ssd`` to another
    scan than its own (a plain or f64 reference)."""
    from . import ops
    b, s, _ = proj.shape
    h, p, n = widths.heads, widths.headdim, widths.state
    dz, c = h * p, conv_w.shape[-1]
    x, bm, cm = conv_fwd_ref(proj[..., dz:dz + c], conv_w, c - 2 * n, n)
    dt_soft, a = dt_fwd_ref(proj[..., dz + c:], dt_bias, a_log)
    x = x.reshape(b, s, h, p)
    y, state = ops.ssd(x, dt_soft, a, bm, cm, widths.chunk, initial_state)
    if out_norm is None:
        return skip_ref(y, x, d_skip).reshape(b, s, dz), state
    return gate_fwd_ref(y, x, proj[..., :dz], d_skip, out_norm)[0], state


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _device(tensors, what: str) -> str:
    """"cpu", "cuda" or "meta": the one device type of ``tensors``, or
    raise."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda",
                                                       "meta"):
        raise ValueError(f"{what}: all tensors must be on one CUDA device, "
                         "or all on the CPU, or all on meta")
    return next(iter(devs)).type


def _check_proj(proj, what: str) -> None:
    if proj.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: the packed projection must be bfloat16 or "
                        f"float32, got {proj.dtype}")
    if proj.dim() != 3 or not proj.is_contiguous() \
            or proj.shape[-1] % CONV_GROUP or proj.data_ptr() % 16:
        raise ValueError(f"{what}: the packed projection must be a "
                         "contiguous, 16-byte aligned (B, S, W) with W a "
                         f"multiple of {CONV_GROUP}, got "
                         f"{tuple(proj.shape)}")


def _check_f32(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned float32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _packed_widths(proj, widths: Widths, channels: int):
    """(dz, dx, c): the z width, x's share of xBC and xBC's width, checked
    against ``proj``'s packed width z | xBC | dt."""
    h, p, n = widths.heads, widths.headdim, widths.state
    dz, dx = h * p, channels - 2 * n
    if dx != dz or proj.shape[-1] != dz + channels + h:
        raise ValueError(
            f"ssd_mixer: a packed projection of {proj.shape[-1]} columns and "
            f"{channels} conv channels do not hold z, x, B, C and dt of "
            f"{h} heads of {p} with state {n}")
    return dz, dx, channels


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_conv_widths(dz, conv_w, n, what):
    c = conv_w.shape[-1]
    if dz % CONV_GROUP or c % CONV_GROUP or n % CONV_GROUP:
        raise ValueError(f"{what}: the kernel takes z, x, B and C widths "
                         f"that are multiples of {CONV_GROUP}, got "
                         f"{dz}, {c - 2 * n}, {n}")
    if tuple(conv_w.shape) != (CONV_WIDTH, c):
        raise ValueError(f"{what}: the kernel takes a conv of width "
                         f"{CONV_WIDTH}, got conv_w {tuple(conv_w.shape)}")


def conv_fwd(proj, conv_w, dt_bias, a_log, widths: Widths):
    """(x (B, S, H, P), B, C (B, S, N), softplus(dt + dt_bias) (B, S, H),
    a (H,)), all f32 contiguous, from ``proj``'s xBC and dt columns."""
    b, s, _ = proj.shape
    dz, dx, c = _packed_widths(proj, widths, conv_w.shape[-1])
    h, p, n = widths.heads, widths.headdim, widths.state
    dev = _device([proj, conv_w, dt_bias, a_log], "ssd_conv_fwd")
    if dev == "cpu":
        x, bm, cm = conv_fwd_ref(proj[..., dz:dz + c], conv_w, dx, n)
        return (x.reshape(b, s, h, p), bm, cm,
                *dt_fwd_ref(proj[..., dz + c:], dt_bias, a_log))
    _check_conv_widths(dz, conv_w, n, "ssd_conv_fwd")
    if dev == "cuda":
        _check_proj(proj, "ssd_conv_fwd")
        _check_f32("ssd_conv_fwd", conv_w=conv_w, dt_bias=dt_bias,
                   a_log=a_log)
    f32 = dict(dtype=torch.float32, device=proj.device)
    x = torch.empty((b, s, h, p), **f32)
    bm, cm = (torch.empty((b, s, n), **f32) for _ in range(2))
    dt_soft = torch.empty((b, s, h), **f32)
    a = torch.empty((h,), **f32)
    if dev == "meta":
        cost.add("ssd_conv", *cost.ssd_conv_flops_bytes(
            b * s, c, h, proj.element_size()))
        return x, bm, cm, dt_soft, a
    esz = proj.element_size()
    err = _lib().ssd_conv_fwd(
        proj.data_ptr() + dz * esz, proj.data_ptr() + (dz + c) * esz,
        proj.shape[-1], *(t.data_ptr() for t in (conv_w, dt_bias, a_log, x,
                                                  bm, cm, dt_soft, a)),
        b, s, c, dx, n, h, int(proj.dtype == torch.bfloat16), _stream(proj))
    _raise(err, "ssd_conv_fwd")
    global launches
    launches += 1
    return x, bm, cm, dt_soft, a


def _gate_checks(y, x, proj, d_skip, gamma, what):
    b, s, h, p = y.shape
    di = h * p
    if di % CONV_GROUP or p % CONV_GROUP or di > GATE_MAX:
        raise ValueError(f"{what}: the kernel takes heads of a multiple of "
                         f"{CONV_GROUP} channels and rows of up to "
                         f"{GATE_MAX}, got {h} heads of {p}")
    if tuple(x.shape) != (b, s, h, p) or tuple(d_skip.shape) != (h,) \
            or tuple(gamma.shape) != (di,):
        raise ValueError(f"{what}: x {tuple(x.shape)}, d_skip "
                         f"{tuple(d_skip.shape)} and gamma "
                         f"{tuple(gamma.shape)} do not match y "
                         f"{tuple(y.shape)}")


def _ctas(proj, per_sm: int) -> int:
    """``per_sm`` CTAs for each SM of ``proj``'s card."""
    return per_sm * torch.cuda.get_device_properties(
        proj.device).multi_processor_count


def gate_fwd(y, x, proj, d_skip, gamma):
    """(out (B, S, H·P) in proj's dtype, rstd (B, S) f32): the gated norm of
    y + D x by silu of ``proj``'s z columns."""
    b, s, h, p = y.shape
    di = h * p
    dev = _device([y, x, proj, d_skip, gamma], "ssd_gate_fwd")
    if dev == "cpu":
        return gate_fwd_ref(y, x, proj[..., :di], d_skip, gamma)
    _gate_checks(y, x, proj, d_skip, gamma, "ssd_gate_fwd")
    if dev == "cuda":
        _check_proj(proj, "ssd_gate_fwd")
        _check_f32("ssd_gate_fwd", y=y, x=x, d_skip=d_skip, gamma=gamma)
    out = torch.empty((b, s, di), dtype=proj.dtype, device=proj.device)
    rstd = torch.empty((b, s), dtype=torch.float32, device=proj.device)
    if dev == "meta":
        cost.add("ssd_gate", *cost.ssd_gate_flops_bytes(
            b * s, di, h, proj.element_size()))
        return out, rstd
    err = _lib().ssd_gate_fwd(
        y.data_ptr(), x.data_ptr(), proj.data_ptr(), proj.shape[-1],
        d_skip.data_ptr(), gamma.data_ptr(), out.data_ptr(), rstd.data_ptr(),
        b * s, di, p, EPS, min(b * s, _ctas(proj, 32)),
        int(proj.dtype == torch.bfloat16), _stream(proj))
    _raise(err, "ssd_gate_fwd")
    global gate_launches
    gate_launches += 1
    return out, rstd


def gate_bwd(dout, y, x, proj, d_skip, gamma, rstd, dproj):
    """(dy (B, S, H, P) f32, d_skip's gradient, gamma's) of ``gate_fwd``'s
    out given ``dout``; dz goes into ``dproj``'s z columns."""
    b, s, h, p = y.shape
    di = h * p
    dev = _device([dout, y, x, proj, d_skip, gamma, dproj], "ssd_gate_bwd")
    if dev == "cpu":
        dy, dz, dd, dg = gate_bwd_ref(dout, y, x, proj[..., :di], d_skip,
                                      gamma)
        dproj[..., :di].copy_(dz)
        return dy, dd, dg
    _gate_checks(y, x, proj, d_skip, gamma, "ssd_gate_bwd")
    if dev == "cuda":
        _check_proj(proj, "ssd_gate_bwd")
        _check_proj(dproj, "ssd_gate_bwd")
        if dout.dtype != proj.dtype or not dout.is_contiguous() \
                or dout.data_ptr() % 16:
            raise ValueError("ssd_gate_bwd: dout must be a contiguous, "
                             f"16-byte aligned {proj.dtype} tensor")
        _check_f32("ssd_gate_bwd", y=y, x=x, d_skip=d_skip, gamma=gamma,
                   rstd=rstd)
    f32 = dict(dtype=torch.float32, device=proj.device)
    dy = torch.empty((b, s, h, p), **f32)
    d_dskip, d_gamma = torch.empty((h,), **f32), torch.empty((di,), **f32)
    if dev == "meta":
        cost.add("ssd_gate_bwd", *cost.ssd_gate_bwd_flops_bytes(
            b * s, di, h, proj.element_size()))
        return dy, d_dskip, d_gamma
    grid = min(b * s, _ctas(proj, 8))   # each CTA one partial
    lib = _lib()
    part = torch.empty((lib.ssd_gate_bwd_scratch(di, p, grid),), **f32)
    err = lib.ssd_gate_bwd(
        dout.data_ptr(), y.data_ptr(), x.data_ptr(), proj.data_ptr(),
        proj.shape[-1], d_skip.data_ptr(), gamma.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dproj.data_ptr(), dproj.shape[-1], part.data_ptr(),
        d_gamma.data_ptr(), d_dskip.data_ptr(), b * s, di, p, grid,
        int(proj.dtype == torch.bfloat16), _stream(proj))
    _raise(err, "ssd_gate_bwd")
    global gate_bwd_launches
    gate_bwd_launches += 1
    return dy, d_dskip, d_gamma


def conv_bwd(proj, conv_w, dx_scan, dy, d_skip, dbm, dcm, ddt, dt_bias, da,
             a, a_log, dproj, widths: Widths):
    """(conv_w's, dt_bias's and a_log's gradients) of ``conv_fwd``, given
    K4-bwd's dx, dB, dC, ddt and da and dy, the gradient of y + D x, whose
    D x term reaches x too; d xBC and d dt go into their columns of
    ``dproj``.  a = -exp(a_log) as ``conv_fwd`` gave it."""
    b, s, _ = proj.shape
    dz, dx, c = _packed_widths(proj, widths, conv_w.shape[-1])
    h, p, n = widths.heads, widths.headdim, widths.state
    tensors = [proj, conv_w, dx_scan, dy, d_skip, dbm, dcm, ddt, dt_bias,
               da, a, a_log, dproj]
    dev = _device(tensors, "ssd_conv_bwd")
    if dev == "cpu":
        dxbc, d_conv_w = conv_bwd_ref(proj[..., dz:dz + c], conv_w, dx_scan,
                                      dy, d_skip, dbm, dcm)
        d_dt, d_bias, d_alog = dt_bwd_ref(ddt, da, proj[..., dz + c:],
                                          dt_bias, a_log)
        dproj[..., dz:dz + c].copy_(dxbc)
        dproj[..., dz + c:].copy_(d_dt)
        return d_conv_w, d_bias, d_alog
    _check_conv_widths(dz, conv_w, n, "ssd_conv_bwd")
    if h > 256:
        raise ValueError(f"ssd_conv_bwd: the kernel takes up to 256 heads, "
                         f"got {h}")
    if dev == "cuda":
        _check_proj(proj, "ssd_conv_bwd")
        _check_proj(dproj, "ssd_conv_bwd")
        _check_f32("ssd_conv_bwd", conv_w=conv_w, dx_scan=dx_scan, dy=dy,
                   d_skip=d_skip, dbm=dbm, dcm=dcm, ddt=ddt,
                   dt_bias=dt_bias, da=da, a=a)
    f32 = dict(dtype=torch.float32, device=proj.device)
    d_conv_w = torch.empty(tuple(conv_w.shape), **f32)
    d_bias, d_alog = torch.empty((h,), **f32), torch.empty((h,), **f32)
    if dev == "meta":
        cost.add("ssd_conv_bwd", *cost.ssd_conv_bwd_flops_bytes(
            b * s, c, dx, h, proj.element_size()))
        return d_conv_w, d_bias, d_alog
    lib = _lib()
    part = torch.empty((lib.ssd_conv_bwd_scratch(b, s, c, h, DT_CTAS),),
                       **f32)
    esz = proj.element_size()
    err = lib.ssd_conv_bwd(
        proj.data_ptr() + dz * esz, proj.data_ptr() + (dz + c) * esz,
        proj.shape[-1], *(t.data_ptr() for t in (
            conv_w, dx_scan, dy, d_skip, dbm, dcm, ddt, dt_bias, da, a)),
        dproj.data_ptr() + dz * esz, dproj.data_ptr() + (dz + c) * esz,
        dproj.shape[-1], part.data_ptr(), d_conv_w.data_ptr(),
        d_bias.data_ptr(), d_alog.data_ptr(), b, s, c, dx, n, h, p, DT_CTAS,
        int(proj.dtype == torch.bfloat16), _stream(proj))
    _raise(err, "ssd_conv_bwd")
    global bwd_launches
    bwd_launches += 1
    return d_conv_w, d_bias, d_alog


# ---------------------------------------------------------------------------
# The stretch and its gradient
# ---------------------------------------------------------------------------

def _forward(proj, conv_w, dt_bias, a_log, d_skip, out_norm, initial_state,
             widths: Widths):
    """(out, final state, what the backward reads)."""
    b, s, _ = proj.shape
    dz = widths.heads * widths.headdim
    x, bm, cm, dt_soft, a = conv_fwd(proj, conv_w, dt_bias, a_log, widths)
    y, final, workspace = ssd_scan._forward(x, dt_soft, a, bm, cm,
                                            widths.chunk, initial_state)
    if out_norm is None:
        out, rstd = skip_ref(y, x, d_skip).reshape(b, s, dz), None
    else:
        out, rstd = gate_fwd(y, x, proj, d_skip, out_norm)
    return out, final, (x, bm, cm, dt_soft, a, y, rstd, workspace)


class SSDMixer(torch.autograd.Function):
    """``ssd_mixer`` with its gradient: the forward kernels and K4, keeping
    what the backward reads; the gated norm's backward, K4-bwd and the
    conv's backward, which return one gradient of ``proj``.  Under
    non-reentrant checkpointing the forward runs again in the backward
    pass, and saves then."""

    @staticmethod
    def forward(ctx, proj, conv_w, dt_bias, a_log, d_skip, out_norm,
                initial_state, widths):
        out, final, saved = _forward(proj, conv_w, dt_bias, a_log, d_skip,
                                     out_norm, initial_state, widths)
        ctx.set_materialize_grads(False)
        ctx.widths = widths
        ctx.save_for_backward(proj, conv_w, dt_bias, a_log, d_skip,
                              out_norm, initial_state, *saved)
        return out, final

    @staticmethod
    def backward(ctx, dout, dfinal):
        (proj, conv_w, dt_bias, a_log, d_skip, out_norm, initial_state,
         x, bm, cm, dt_soft, a, y, rstd, workspace) = ctx.saved_tensors
        w = ctx.widths
        b, s, wp = proj.shape
        dz = w.heads * w.headdim
        if dout is None:
            dout = torch.zeros((b, s, dz), dtype=proj.dtype if out_norm
                               is not None else torch.float32,
                               device=proj.device)
        dout = dout.contiguous()
        dproj = torch.empty_like(proj)
        if out_norm is None:
            # y + D x went to the caller's norm: dout is its gradient, and
            # z's gradient reaches proj through the caller's slice
            dy = dout.reshape(x.shape)
            d_dskip = (dy * x).sum((0, 1, 3))
            d_norm = None
            dproj[..., :dz].zero_()
        else:
            dy, d_dskip, d_norm = gate_bwd(dout, y, x, proj, d_skip, out_norm,
                                           rstd, dproj)
        dx, ddt, da, dbm, dcm, dinit = ssd_scan.ssd_scan_bwd(
            x, dt_soft, a, bm, cm, w.chunk, initial_state, dy,
            None if dfinal is None else dfinal.contiguous(), workspace)
        d_conv_w, d_bias, d_alog = conv_bwd(
            proj, conv_w, dx, dy, d_skip, dbm, dcm, ddt, dt_bias, da, a,
            a_log, dproj, w)
        return (dproj, d_conv_w, d_bias, d_alog, d_dskip, d_norm, dinit,
                None)


def ssd_mixer(proj, conv_w, dt_bias, a_log, d_skip, out_norm,
              initial_state, widths: Widths):
    """proj: (B, S, H·P + C + H) packed z | xBC | dt in the compute dtype,
    C = H·P + 2N the conv's channels; conv_w (4, C), dt_bias, a_log,
    d_skip (H,), out_norm (H·P,) f32; initial_state (B, H, P, N) f32 or
    None.  Returns (out, final state (B, H, P, N) f32): out (B, S, H·P) is
    the gated, normed input of the out-projection in proj's dtype, or, with
    ``out_norm`` None, y + D x in f32 for the caller's norm.

    On the card: proj bfloat16 or float32, contiguous; the widths multiples
    of 8, H·P at most 8192; K4's shapes (``ssd_scan``).  Differentiable:
    with grad enabled and an input that requires it, the call goes through
    ``SSDMixer``."""
    inputs = [proj, conv_w, dt_bias, a_log, d_skip, out_norm, initial_state]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return SSDMixer.apply(*inputs, widths)
    return _forward(*inputs, widths)[:2]

