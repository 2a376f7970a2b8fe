#!/usr/bin/env python3
"""Where K4-bwd's time goes, on one NVIDIA card.

  python3 tools/ssd_bwd_probe.py

Builds ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` as it is and in
variants made by text substitutions into ``build/ssd_bwd_probe/`` (nvcc,
the flags of ``kernels/_build.py``); holds the unmodified source against
``ref.ssd_chunked_bwd_ref`` at a few shapes (two calls bit-identical); then
times each variant at mamba2-370m's training shape (B, S, H, P, N) = (2,
4096, 32, 64, 128), chunk 128: one call by CUDA events and each launch by
the profiler.  Variants that cut a part out give wrong gradients and serve
timing only: the route of mma.sync for comparison; the products, tile
fetches and A loads of every wgmma launch; the fused launch's tile splits
and dS epilogue, its exps and column sums; dB/dC's carried terms.  Each
variant's texts must occur once in the source (``apply`` raises otherwise;
tests/test_torch_build.py checks them on the CPU).  Prints ptxas's
registers, spills and wgmma notes for the unmodified source, then one line
per variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

PRODUCTS = """    hopper::wgmma_tf32_rs<kN>(acc, al, dh, 1);
    hopper::wgmma_tf32_rs<kN>(acc, ah, dl, 1);
    hopper::wgmma_tf32_rs<kN>(acc, ah, dh, 1);
"""
# name: [(text in the source, its replacement)]; each text must occur
# exactly once (tests/test_torch_build.py checks that on the CPU)
VARIANTS = {
    "as is": [],
    "route of mma.sync": [("    tc_route = tc::takes(p, n, CL);",
                           "    tc_route = false;")],
    "without products": [(PRODUCTS, "")],
    "without tile fetches": [
        ("    cp_async16(raw + r * rs + c, src + (size_t)r * gs + c);\n", "")],
    "fused without splits": [("    switch (k & 3) {\n      case 0: split",
                              "    switch (4) {\n      case 0: split")],
    "without A loads": [("    if (p + 2 < p1) load(p + 2, nxt2);\n", "")],
    "fused without dS": [("          if (jt > 2 * m + 1) continue;",
                          "          continue;")],
    "dS without exp": [
        ("dec[v] = j0 + v <= ii ? expf(cs_s[ii] - cs_s[j0 + v]) * dt_s[j0 + v]",
         "dec[v] = j0 + v <= ii ? dt_s[j0 + v]")],
    "dS without column sums": [
        ("          if (g == 0)\n            *reinterpret_cast<float2*>(colp",
         "          if (g == 9)\n            *reinterpret_cast<float2*>(colp")],
    "dB/dC without carried terms": [
        ("      product<kN>(acc, ts, n * 128, 0, P / 16, load, shape);\n", "")],
}
# (B, S, H, P, N, chunk): the route of mma.sync (chunk 8-32, P 12), then the
# tensor-core route: jamba's N = 16, chunk 64, mamba2-370m's widths
SHAPES = [(1, 32, 2, 8, 16, 16), (2, 32, 4, 4, 8, 8), (1, 96, 5, 12, 24, 32),
          (2, 384, 3, 64, 16, 128), (1, 256, 2, 64, 128, 64),
          (1, 512, 4, 64, 128, 128), (2, 4096, 32, 64, 128, 128)]


def apply(src: str, name: str, subs) -> str:
    """The source with a variant's substitutions; raises unless each text
    occurs exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old[:60]!r} occurs "
                             f"{src.count(old)} times in the source, not once")
        src = src.replace(old, new)
    return src


def build():
    out = ROOT / "build" / "ssd_bwd_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    texts = {name: apply(src, name, subs) for name, subs in VARIANTS.items()}
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (out / f"libv{i}.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"libv{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load("ssd_scan")
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name!r} does not build:\n{log[-3000:]}")
        if name == "as is":               # registers, spills, wgmma notes
            for line in log.splitlines():
                if "fused" in line or "C75" in line:
                    print("ptxas:", line.strip()[:160], flush=True)
                elif "registers" in line or "spill" in line:
                    print("ptxas:   ", line.strip()[:100], flush=True)
        lib = ctypes.CDLL(str(path))
        lib.ssd_scan_bwd.argtypes = ([ctypes.c_void_p] * 15
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_scan_bwd_workspace.argtypes = [ctypes.c_int] * 6
        lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def bwd(lib, x, dt, a, bm, cm, chunk, init, dy, dfinal, work):
    b, s, h, p = x.shape
    n = bm.shape[-1]
    dx, dbm, dcm = (torch.empty_like(t) for t in (x, bm, cm))
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    dinit = None if init is None else torch.empty_like(init)
    scratch = torch.empty((lib.ssd_scan_bwd_workspace(b, s, h, p, n, chunk),),
                          device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = lib.ssd_scan_bwd(*map(ptr, (x, dt, a, bm, cm, dy, dfinal, work, dx,
                                      ddt, da, dbm, dcm, dinit, scratch)),
                           b, s, h, p, n, chunk,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"ssd_scan_bwd failed: cudaError {err}")
    return dx, ddt, da, dbm, dcm, dinit


def inputs(gen, b, s, h, p, n, chunk, extra):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, dy = randn(b, s, h, p), randn(b, s, h, p)
    dt = 0.70 + 0.12 * torch.rand((b, s, h), generator=gen, device="cuda")
    a = -(0.9 + 0.1 * torch.rand((h,), generator=gen, device="cuda"))
    bm, cm = randn(b, s, n), randn(b, s, n)
    init, dfinal = (randn(b, h, p, n), randn(b, h, p, n)) if extra else (None, None)
    work = ss._forward(x, dt, a, bm, cm, chunk, init)[2]
    return x, dt, a, bm, cm, chunk, init, dy, dfinal, work


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    libs = build()
    gen = torch.Generator("cuda").manual_seed(0)
    for shape in SHAPES:
        args = inputs(gen, *shape, extra=shape[1] < 4096)
        got = bwd(libs["as is"], *args)
        want = ref.ssd_chunked_bwd_ref(*args[:9])
        errs = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want) if w is not None]
        same = all(torch.equal(g, g2) for g, g2 in
                   zip(got, bwd(libs["as is"], *args)) if g is not None)
        print(f"check {shape}: max_abs_err / |max| "
              + " ".join(f"{e:.2e}" for e in errs) + f"; repeat same {same}",
              flush=True)
        if max(errs) > 1e-4 or not same:
            sys.exit("the unmodified source disagrees with the plain version")
    args = inputs(gen, 2, 4096, 32, 64, 128, 128, extra=False)
    for name, lib in libs.items():
        for _ in range(3):
            bwd(lib, *args)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(10):
            bwd(lib, *args)
        e1.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                bwd(lib, *args)
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "ssd_bwd_" in e.name:
                k = e.name.split("ssd_bwd_")[1].split("_kernel")[0]
                us, c = by.get(k, (0.0, 0))
                by[k] = (us + e.device_time, c + 1)
        print(f"{name:30s} {e0.elapsed_time(e1) / 10:.4f} ms a call | " + " ".join(
            f"{k} {us / c / 1e3:.4f}" for k, (us, c) in
            sorted(by.items(), key=lambda kv: -kv[1][0])), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
