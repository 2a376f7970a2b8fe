"""The Mamba-2 layer's fused stretch (``kernels/ssd_fused.py``) on the CPU.

``ops.ssd_mixer`` runs ``SSDMixer``'s glue around each kernel's plain
version here.  It is held bit for bit to the unfused stretch that
``models/ssm.py::ssd_layer`` ran before the fused kernels (transcribed
below as ``unfused_stretch``: the causal conv, the casts of x, B and C,
softplus(dt), the scan, the D skip, the gate and the norm): the output,
the final state and the gradients of the packed in-projection output,
``conv_w``, ``dt_bias``, ``a_log``, ``d_skip`` and ``out_norm``.  At
mamba2-370m's SMOKE widths and at jamba's head and state widths, in f32
and bf16, with the heads whole and split over a fake group of 4 (the
norm's sum of squares then goes through ``runtime.psum``, outside the
stretch).  Meta tensors give the kernels' shapes and add their formulas
to the cost counter; no kernel's name matches a benchmark roofline
reader's.
"""

import dataclasses
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import cost, ops, ssd_fused
from repro_torch.launch.dryrun import fake_group
from repro_torch.models import ssm
from repro_torch.models.modules import rmsnorm

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# (heads, headdim, state, chunk, heads on one process of 4 where split)
WIDTHS = {"mamba2-smoke": (8, 16, 16, 16, 2),
          "jamba": (128, 64, 16, 16, 32)}


def unfused_stretch(proj, conv_w, dt_bias, a_log, d_skip, out_norm, init,
                    widths, sum_over=None):
    """ssm.ssd_layer between the projections as it was before the fused
    kernels: the packed output's three slices, the conv in the compute
    dtype, x, B and C widened to f32 for the scan, the D skip in f32, the
    gate in the compute dtype and ``rmsnorm`` (over a split row with
    ``sum_over``)."""
    h, p, st, chunk = widths
    di, cdt = h * p, proj.dtype
    c = conv_w.shape[-1]
    z, xbc, dt = proj[..., :di], proj[..., di:di + c], proj[..., di + c:]
    w = conv_w.to(cdt)
    pad = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    xbc = F.silu(sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
                     for i in range(w.shape[0])))
    b, s, _ = xbc.shape
    xh = xbc[..., :di].float().reshape(b, s, h, p)
    bmat = xbc[..., di:di + st].float().contiguous()
    cmat = xbc[..., di + st:].float().contiguous()
    dt_soft = F.softplus(dt.float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    y, state = ops.ssd(xh.contiguous(), dt_soft, a, bmat, cmat, chunk, init)
    y = y + d_skip.float()[None, None, :, None] * xh
    y = y.reshape(b, s, di).to(cdt) * F.silu(z)
    return rmsnorm(y, out_norm, sum_over=sum_over), state


def fused_stretch(proj, conv_w, dt_bias, a_log, d_skip, out_norm, init,
                  widths, sum_over=None):
    """The same stretch as ssm.ssd_layer runs it now: ``ops.ssd_mixer``,
    and with a split row the composite norm after it."""
    h, p, st, chunk = widths
    w = ssd_fused.Widths(h, p, st, chunk)
    if sum_over is None:
        return ops.ssd_mixer(proj, conv_w, dt_bias, a_log, d_skip, out_norm,
                             init, w)
    y, state = ops.ssd_mixer(proj, conv_w, dt_bias, a_log, d_skip, None,
                             init, w)
    z = proj[..., :h * p]
    return rmsnorm(y.to(proj.dtype) * F.silu(z), out_norm,
                   sum_over=sum_over), state


def _inputs(widths, dtype, batch=2, seq=32, with_state=False, seed=0):
    """Leaves of the stretch from numpy: the packed projection (z | xBC |
    dt) in the compute dtype, the f32 parameters at their init's ranges,
    and an initial state."""
    h, p, st, _ = widths
    rng = np.random.default_rng(seed)
    di, c = h * p, h * p + 2 * st
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    proj = torch.from_numpy(f(batch, seq, di + c + h)).to(TDT[dtype])
    params = [torch.from_numpy(f(4, c) * 0.5),                    # conv_w
              torch.from_numpy(rng.uniform(-4, -2, h).astype(np.float32)),
              torch.from_numpy(np.log(rng.uniform(1, 16, h))
                               .astype(np.float32)),              # a_log
              torch.from_numpy(1 + 0.1 * f(h)),                   # d_skip
              torch.from_numpy(1 + 0.1 * f(di))]                  # out_norm
    init = torch.from_numpy(f(batch, h, p, st)) if with_state else None
    return [proj] + params + [init]


def _run(stretch, leaves, widths, seed=1, sum_over=None):
    """(out, state, grads of the six leaves) of a fixed loss of both."""
    leaves = [t if t is None else t.detach().clone().requires_grad_(i < 6)
              for i, t in enumerate(leaves)]
    out, state = stretch(*leaves, widths, sum_over=sum_over)
    g = torch.Generator().manual_seed(seed)
    loss = (out.float() * torch.randn(out.shape, generator=g)
            .to(out.device)).sum() \
        + (state * torch.randn(state.shape, generator=g)
           .to(state.device)).sum()
    grads = torch.autograd.grad(loss, leaves[:6])
    return out.detach(), state.detach(), grads


NAMES = ("out", "state", "proj", "conv_w", "dt_bias", "a_log", "d_skip",
         "out_norm")


def _assert_same(got, want):
    got = [got[0], got[1], *got[2]]
    want = [want[0], want[1], *want[2]]
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, float((a.float() - b.float())
                                               .abs().max()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_stretch_equals_the_unfused_layer_bit_for_bit(arch, dtype):
    widths = WIDTHS[arch][:4]
    leaves = _inputs(widths, dtype, with_state=arch == "mamba2-smoke")
    _assert_same(_run(fused_stretch, leaves, widths),
                 _run(unfused_stretch, leaves, widths))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_stretch_with_heads_split_equals_the_unfused_layer(arch, dtype):
    """One process's heads of 4 (a fake group: the norm's psum moves
    nothing, alike on both paths); z's gradient reaches the packed output
    through the caller's slice, the rest through the stretch's own."""
    h, p, st, chunk, local = WIDTHS[arch]
    widths = (local, p, st, chunk)
    leaves = _inputs(widths, dtype, seed=2)
    with fake_group(4):
        sum_over = (dist.group.WORLD, h * p)
        _assert_same(_run(fused_stretch, leaves, widths, sum_over=sum_over),
                     _run(unfused_stretch, leaves, widths,
                          sum_over=sum_over))
    assert not dist.is_initialized()


def _old_layer(lp, x, cfg):
    """ssm.ssd_layer with the heads whole as it was before the fused
    kernels."""
    xn = rmsnorm(x, lp["norm"])
    proj = xn @ lp["w_in"].to(cfg.compute_dtype)
    widths = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    out, _ = unfused_stretch(proj, lp["conv_w"], lp["dt_bias"], lp["a_log"],
                             lp["d_skip"], lp["out_norm"], None, widths)
    return x + out @ lp["w_out"].to(cfg.compute_dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_layer_equals_the_unfused_layer_bit_for_bit(dtype):
    """The whole layer and every one of its parameters' gradients."""
    cfg = dataclasses.replace(get_config("mamba2-370m", smoke=True),
                              compute_dtype=TDT[dtype])
    params = ssm.init(cfg, torch.Generator().manual_seed(3), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)).to(TDT[dtype])
    res = []
    for layer in (lambda lp, x: ssm.ssd_layer(lp, x, cfg),
                  lambda lp, x: _old_layer(lp, x, cfg)):
        lp = {k: v[0].detach().clone().requires_grad_()
              for k, v in params["layers"].items()}
        out = layer(lp, x)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
        grads = torch.autograd.grad((out.float() * g).sum(), list(lp.values()))
        res.append((out.detach(), dict(zip(lp, grads))))
    (out, grads), (want, want_grads) = res
    assert torch.equal(out, want)
    for name in want_grads:
        assert torch.equal(grads[name], want_grads[name]), name


def test_a_model_axis_of_one_runs_the_layer_as_one_process(tmp_path):
    """On a mesh whose model axis is 1 the step takes the split path with
    one block of heads: the whole row is on the process, so the gated norm
    runs inside the stretch and the layer gives the one-process bits."""
    from repro_torch.parallel.ctx import activation_rules
    from repro_torch.parallel.sharding import Mesh, default_rules
    cfg = get_config("mamba2-370m", smoke=True)
    params = ssm.init(cfg, torch.Generator().manual_seed(6), "cpu")
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(6)).to(cfg.compute_dtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))

    def run():
        lp = {k: v[0].detach().clone().requires_grad_()
              for k, v in params["layers"].items()}
        out = ssm.ssd_layer(lp, x, cfg)
        return out, torch.autograd.grad((out.float() * g).sum(),
                                        list(lp.values()))

    want, want_grads = run()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = Mesh(("data", "model"), (1, 1), "cpu")
        with activation_rules(mesh, default_rules(mesh), None,
                              dist.group.WORLD):
            assert ssm._head_split(cfg).size == 1
            got, grads = run()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_meta_tensors_give_the_kernels_shapes_and_add_their_formulas():
    """Forward and backward on meta tensors: each output and gradient has
    the plain path's shape and dtype; the four kernels' and K4's formulas
    are added once each."""
    widths = (8, 16, 16, 16)
    h, p, st, chunk = widths
    leaves = _inputs(widths, "bf16")
    want = _run(fused_stretch, leaves, widths)
    meta = [t if t is None else t.to(META) for t in leaves]
    c = cost.Cost()
    with cost.counting(c):
        got = _run(fused_stretch, meta, widths)
    for name, a, b in zip(NAMES, [got[0], got[1], *got[2]],
                          [want[0], want[1], *want[2]]):
        assert a.device == META and (a.shape, a.dtype) == (b.shape,
                                                           b.dtype), name
    rows, di, cw = 2 * 32, h * p, h * p + 2 * st
    parts = [cost.ssd_conv_flops_bytes(rows, cw, h, 2),
             cost.ssd_gate_flops_bytes(rows, di, h, 2),
             cost.ssd_gate_bwd_flops_bytes(rows, di, h, 2),
             cost.ssd_conv_bwd_flops_bytes(rows, cw, di, h, 2),
             cost.ssd_flops_bytes(2, 32, h, p, st, False),
             cost.ssd_bwd_flops_bytes(2, 32, h, p, st, chunk, False, True)]
    assert c.calls == {"ssd_conv": 1, "ssd_gate": 1, "ssd_gate_bwd": 1,
                       "ssd_conv_bwd": 1, "ssd_scan": 1, "ssd_scan_bwd": 1}
    assert (c.flops, c.bytes) == (sum(f for f, _ in parts),
                                  sum(b for _, b in parts))


def test_no_grad_runs_the_forward_alone():
    widths = (8, 16, 16, 16)
    leaves = _inputs(widths, "bf16", with_state=True)
    with torch.no_grad():
        out, state = fused_stretch(*leaves, widths)
        want, want_state = unfused_stretch(*leaves, widths)
    assert not out.requires_grad
    assert torch.equal(out, want) and torch.equal(state, want_state)


def test_shapes_the_kernels_do_not_take_raise_on_meta():
    """The widths the kernels refuse raise before any launch (the same
    checks run for CUDA tensors), and the packed width must hold z, xBC
    and dt."""
    w = ssd_fused.Widths(2, 6, 16, 16)            # x of 12: not whole groups
    proj = torch.empty((1, 16, 12 + 44 + 2), device=META)
    args = [torch.empty(s, device=META) for s in ((4, 44), (2,), (2,))]
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_fused.conv_fwd(proj, *args, w)
    with pytest.raises(ValueError, match="do not hold"):
        ssd_fused.conv_fwd(proj[..., 1:], *args, w)


def _global_names():
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "ssd_fused.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)", src)


def test_no_kernel_name_matches_a_roofline_reader():
    """The benchmark's K3 and K4 roofline readers pick device ops by name
    (``gpubench/kernels/*.py``'s ``matches``): none of these kernels may
    count as theirs."""
    names = _global_names()
    assert len(names) == 7
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    readers = [importlib.import_module(f"gpubench.kernels.{f.stem}")
               for f in sorted((ROOT / "gpubench" / "kernels").glob("k*.py"))]
    assert readers
    for reader in readers:
        for name in names:
            for shown in (name, f"(anonymous namespace)::{name}<float, 4>",
                          f"void (anonymous namespace)::{name}<__nv_bfloat16,"
                          " 1>(__nv_bfloat16 const*, long long)"):
                assert not reader.matches(shown), (reader.__name__, name)


def test_ssd_layer_routes_through_the_mixer(monkeypatch):
    """ssd_layer reads ``ops.ssd_mixer`` when it runs, so a run can swap
    the stretch for its plain composite (``ssd_mixer_ref``); swapping
    ``ops.ssd`` does that too (below)."""
    cfg = get_config("mamba2-370m", smoke=True)
    params = ssm.init(cfg, torch.Generator().manual_seed(5), "cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5)).to(cfg.compute_dtype)
    calls = []

    def plain(*args):
        calls.append(args[-1])
        return ssd_fused.ssd_mixer_ref(*args)

    want = ssm.ssd_layer(lp, x, cfg)
    monkeypatch.setattr(ops, "ssd_mixer", plain)
    got = ssm.ssd_layer(lp, x, cfg)
    assert calls == [ssd_fused.Widths(cfg.ssm_heads, cfg.ssm_headdim,
                                      cfg.ssm_state, cfg.ssm_chunk)]
    assert ssd_fused.CONV_WIDTH == ssm.D_CONV
    assert torch.equal(got, want)


@pytest.mark.parametrize("grad", [False, True])
def test_swapping_the_scan_alone_runs_the_whole_stretch_plain(monkeypatch,
                                                              grad):
    """``ops.ssd`` is the one seam of the scan: a run that sets it to a
    reference scan gets the stretch plain around that scan, as if it had
    set ``ops.ssd_mixer`` to ``ssd_mixer_ref`` too, and no fused wrapper
    runs (so a reference run can never keep K4)."""
    from repro_torch.kernels import ref
    cfg = get_config("mamba2-370m", smoke=True)
    params = ssm.init(cfg, torch.Generator().manual_seed(8), "cpu")
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(8)).to(cfg.compute_dtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    calls = []

    def scan(*args):
        calls.append(tuple(args[0].shape))
        return ref.ssd_chunked_ref(*args)

    def run():
        lp = {k: v[0].detach().clone().requires_grad_(grad)
              for k, v in params["layers"].items()}
        with torch.set_grad_enabled(grad):
            out = ssm.ssd_layer(lp, x, cfg)
        grads = (torch.autograd.grad((out.float() * g).sum(),
                                     list(lp.values())) if grad else ())
        return out.detach(), grads

    monkeypatch.setattr(ops, "ssd", scan)
    with monkeypatch.context() as m:
        m.setattr(ops, "ssd_mixer", ssd_fused.ssd_mixer_ref)
        want, want_grads = run()
    assert len(calls) == 1

    def refuse(*args, **kwargs):
        raise AssertionError("a fused wrapper ran with the scan swapped")

    for name in ("conv_fwd", "gate_fwd", "gate_bwd", "conv_bwd", "_forward"):
        monkeypatch.setattr(ssd_fused, name, refuse)
    got, grads = run()
    assert len(calls) == 2
    assert torch.equal(got, want)
    assert len(grads) == len(want_grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
