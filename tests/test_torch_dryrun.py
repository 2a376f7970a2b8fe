"""The port's dry-run (``repro_torch.launch.dryrun``) and the kernels' meta
branches, on the CPU.

The dry-run's exact fields (params, active params, devices, kind, model
flops per device) equal the JAX dry-run's, and its argument bytes lie
within 0.1% of XLA's, on the four cells where the JAX dry-run runs
(``tools/dryrun_compare.py``: two as shipped, train_4k and prefill_32k on
an Auto-axes mesh, ROADMAP F17).  Its flops per device, one device's step
counted as XLA counts, lie within [0.9, 1.1] of XLA's for olmo-1b
train_4k and prefill_32k; decode_32k and long_500k are held to the gap
PERF.md records, which is the runtime's layout (ROADMAP item 16).  Each
kernel wrapper given meta tensors returns its plain version's shapes and
dtypes and adds exactly its ``kernels/cost.py`` formula; the meta
counter, the collectives of a step (counted by hand) and the CLI are
checked on hand-computed cases, and the dry-run refuses a live process
group and leaves none behind.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as J_ARCHS
from repro.launch import shapes as j_shapes
from repro_torch.configs import get_config
from repro_torch.kernels import cost, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gc_compact
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")


def _tool():
    path = ROOT / "tools" / "dryrun_compare.py"
    spec = importlib.util.spec_from_file_location("dryrun_compare", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


COMPARE = _tool()


@pytest.fixture(scope="module")
def reference():
    return COMPARE.reference_results()


# port / XLA flops per device: within [0.9, 1.1] where the two programs
# split the work alike; where they do not, the gap PERF.md §6 records
# (decode: XLA splits the heads over the whole cache, the runtime the
# cache's sequence; long_500k: the runtime runs the batch of 1 on every
# data process, XLA splits the FSDP contractions)
FLOPS_RATIO = {("olmo-1b", "train_4k"): (0.9, 1.1),
               ("olmo-1b", "prefill_32k"): (0.9, 1.1),
               ("olmo-1b", "decode_32k"): (0.35, 0.45),
               ("mamba2-370m", "long_500k"): (10.0, 20.0)}


@pytest.mark.parametrize("arch,shape,patched", COMPARE.CELLS)
def test_dryrun_fields_match_jax(reference, arch, shape, patched):
    want = reference[f"{arch} {shape}"]
    got = dryrun.run_cell(arch, shape, False, "")
    for key in ("arch", "shape", "mesh", "params", "active_params",
                "devices", "kind"):
        assert got[key] == want[key], key
    assert got["roofline"]["model_flops_per_dev"] == \
        want["roofline"]["model_flops_per_dev"]
    arg, xla = got["memory"]["argument_bytes"], \
        want["memory"]["argument_bytes"]
    assert abs(arg - xla) <= 1e-3 * xla, (arg, xla)
    lo, hi = FLOPS_RATIO[(arch, shape)]
    ratio = got["cost"]["flops_per_dev"] / want["cost"]["flops_per_dev"]
    assert lo <= ratio <= hi, ratio
    assert got["cost"]["hbm_bytes_per_dev"] > 0
    assert got["cost"]["transcendentals_per_dev"] > 0
    assert set(got["collective_calls"]) == set(got["collectives"])
    assert got["collective_bytes_per_dev"] == sum(
        got["collectives"].values()) > 0
    assert got["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


def test_dryrun_cli_skips_as_jax_and_fails_nothing(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--all", "--shape", "long_500k", "--both-meshes",
                          "--out", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and not [x for x in lines if x.startswith("FAIL")]
    _, skipped = j_shapes.cells(J_ARCHS, ["long_500k"])
    assert [x for x in lines if x.startswith("SKIP")] == \
        [f"SKIP {a} {s}: {r}" for a, s, r in skipped]
    ok = [x.split()[1:4] for x in lines if x.startswith("OK")]
    assert ok == [[a, "long_500k", m] for a in ("mamba2_370m",
                                                "jamba_v0_1_52b")
                  for m in ("16x16", "2x16x16")]
    written = json.loads((tmp_path / "mamba2_370m_long_500k_2x16x16.json")
                         .read_text())
    assert written["devices"] == 512 and written["kind"] == "decode"
    assert written["cost"]["kernel_calls"] == {}
    assert written["rules"] == "long_context"
    # each mesh is a program of its own, run on its own fake group: the
    # cache's sequence splits 512 ways on the pod mesh, 256 on the other
    first = json.loads((tmp_path / "mamba2_370m_long_500k_16x16.json")
                       .read_text())
    assert first["compile_s"] > 0 and written["compile_s"] > 0
    assert first["devices"] == 256
    assert not dist.is_initialized()


def test_dryrun_meta_run_reaches_the_kernels_meta_branches(monkeypatch):
    """A chunked-attention transformer train step and a Mamba-2 prefill:
    K3 and K3-bwd add their formulas, once a layer each (and K3 once more
    a layer for the recompute under remat "full"); K4 and the SSD layer's
    fused conv once a layer (its heads split over the 16-wide model axis,
    the gated norm stays a composite over processes)."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), attn_impl="chunked"))
    r = dryrun.run_cell("olmo-1b", "train_4k", False, "")
    monkeypatch.undo()
    assert r["cost"]["kernel_calls"] == {"flash_attention": 32,
                                         "flash_attention_bwd": 16}
    r = dryrun.run_cell("mamba2-370m", "prefill_32k", False, "")
    assert r["cost"]["kernel_calls"] == {"ssd_scan": 48, "ssd_conv": 48}


def test_meta_counter_counts_products_bytes_and_peak():
    a = torch.empty(4, 8, device=META)
    b = torch.empty(8, 16, device=META)
    counter = dryrun._MetaCounter()
    with counter:
        c = a @ b                          # 2·4·8·16 flops, 32+128+64 floats
        d = c.t()                          # a view: no bytes, no storage
        e = torch.empty(1000, device=META)  # an allocation: no bytes
        del e
        f = d + 1                          # 64 + 64 floats, 64 flops
    assert counter.flops == 2 * 4 * 8 * 16 + 64
    assert counter.bytes == 4 * (32 + 128 + 64) + 4 * (64 + 64)
    assert counter.peak == 4 * 1000 + 4 * 64
    assert counter.live == 4 * 64 * 2      # c (viewed by d) and f
    del c, d, f
    assert counter.live == 0


def test_collective_bytes_hand_computed():
    """olmo-1b SMOKE (2 layers, d_model 64, 4 heads of 16, ff 128, vocab
    256; f32 params, bf16 activations) training under remat "full" on a
    (2, 2) (data, model) mesh, batch 4 × seq 8: each process computes 2
    rows, its blocks split over data (FSDP, 2 ways) and, but the norms,
    over model."""
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              remat="full")
    p = dryrun.plan(cfg, "train", 4, 8, model=2, world=4)
    # one layer's blocks, in floats: attn_norm and ffn_norm (64 over data),
    # wq, wk, wv (64 × 4 × 16 over data and model), wo (4 × 16 × 64), the
    # FFN's wi and wg (64 × 128) and wo (128 × 64)
    norms, attn, ffn = 2 * 32, 4 * 32 * 2 * 16, 3 * 32 * 64
    top = 128 * 32 + 32 * 128            # embed, unembed
    final_norm = 32
    # all-gathers: each layer's 9 leaves, whole over data (twice a block),
    # in its forward and again in its recompute; embed, unembed and
    # final_norm once; f32
    gathers = 2 * 2 * 9 + 3
    gathered = 4 * 2 * (2 * 2 * (norms + attn + ffn) + top + final_norm)
    # reduce-scatters: the gradient of each leaf the loss reads (the norm
    # gains it does not read get none), its f32 block: 7 a layer, embed
    # and unembed
    scatters, scattered = 2 * 7 + 2, 4 * (2 * (attn + ffn) + top)
    # all-reduces of a (2, 8, 64) bf16 activation, 2048 bytes: from_model
    # after attention and the FFN in the forward, and after attention again
    # in the recompute (it stops at the last tensor the backward needs),
    # to_model's gradient at attention's and the FFN's input, the
    # vocabulary-parallel embedding's from_model and the unembedding's
    # to_model; the loss's MAX and two SUMs of (2, 8) f32; the global
    # count and loss (f32 scalars, over data); global_norm's Σ g² of the
    # 12 leaves split over data and of the 9 split over model
    act = 2 * 8 * 64 * 2
    reduces = 2 * 5 + 2 + 3 + 2 + 2
    reduced = 2 * 5 * act + 2 * act + 3 * 2 * 8 * 4 + 2 * 4 + (12 + 9) * 4
    assert dryrun._MetaCounter is type(p.counter)
    assert p.counter.collectives == {
        "all-gather": {"calls": gathers, "bytes": gathered},
        "reduce-scatter": {"calls": scatters, "bytes": scattered},
        "all-reduce": {"calls": reduces, "bytes": reduced}}
    assert not dist.is_initialized()


def test_dryrun_refuses_a_live_group(tmp_path):
    """A count against a live group would move data: the dry-run refuses
    to start where a process group exists, and leaves it as it was."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.plan(get_config("olmo-1b", smoke=True), "prefill", 4, 8,
                        model=1, world=4)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The kernels' meta branches: the plain version's shapes and dtypes, and
# exactly the cost.py formula
# ---------------------------------------------------------------------------

def _meta(*tensors):
    return [t.to(META) for t in tensors]


def _same_shapes(got, want):
    got, want = (x if isinstance(x, (tuple, list)) else (x,)
                 for x in (got, want))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(t.shape, t.dtype, "meta") for t in want]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_meta_branch(causal, dtype):
    b, s, h, hkv, d = 2, 24, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=g).to(dtype)
            for _ in range(2))
    out, lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
    c = cost.Cost()
    before = fa.launches
    with cost.counting(c):
        got = fa.flash_attention(*_meta(q, k, v), causal=causal)
    _same_shapes(got, out)
    assert (c.flops, c.bytes) == cost.flash_attention_flops_bytes(
        b, s, h, hkv, d, q.element_size(), causal)
    assert fa.launches == before       # a meta call launches nothing
    # with a gradient: the forward writes lse, the backward adds its own
    qm, km, vm = (t.requires_grad_() for t in _meta(q, k, v))
    c = cost.Cost()
    with cost.counting(c):
        o = fa.flash_attention(qm, km, vm, causal=causal)
        grads = torch.autograd.grad(o, (qm, km, vm), torch.empty_like(o))
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, out, causal)
    _same_shapes(grads, want)
    f1, b1 = cost.flash_attention_flops_bytes(b, s, h, hkv, d,
                                              q.element_size(), causal, True)
    f2, b2 = cost.attention_bwd_flops_bytes(q, k, causal)
    assert (c.flops, c.bytes) == (f1 + f2, b1 + b2)
    assert c.calls == {"flash_attention": 1, "flash_attention_bwd": 1}


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_meta_branch(with_state):
    b, s, h, p, n, chunk = 2, 32, 3, 8, 16, 8
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g)
    a = -torch.rand(h, generator=g)
    bm, cm = (torch.randn(b, s, n, generator=g) for _ in range(2))
    init = torch.randn(b, h, p, n, generator=g) if with_state else None
    want = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk, init)
    args = _meta(x, dt, a, bm, cm)
    minit = None if init is None else init.to(META)
    c = cost.Cost()
    with cost.counting(c):
        got = ops.ssd(*args, chunk, minit)
    _same_shapes(got, want)
    assert (c.flops, c.bytes) == cost.ssd_flops_bytes(b, s, h, p, n,
                                                      with_state)
    dy, dfinal = torch.randn_like(x), torch.randn(b, h, p, n)
    grads = ref.ssd_chunked_bwd_ref(x, dt, a, bm, cm, chunk, init, dy,
                                    dfinal)
    _, _, workspace = ss._forward(*args, chunk, minit)
    c = cost.Cost()
    with cost.counting(c):
        got = ss.ssd_scan_bwd(*args, chunk, minit, dy.to(META),
                              dfinal.to(META), workspace)
    _same_shapes([t for t in got if t is not None],
                 [t for t in grads if t is not None])
    assert (got[-1] is None) == (init is None)
    assert (c.flops, c.bytes) == cost.ssd_bwd_flops_bytes(
        b, s, h, p, n, chunk, with_state, True)


def test_paged_attention_meta_branch():
    b, h, hkv, d, p_total, page, n_pages = 3, 8, 2, 32, 16, 4, 5
    g = torch.Generator().manual_seed(2)
    q = torch.randn(b, h, d, generator=g)
    kp, vp = (torch.randn(p_total, page, hkv, d, generator=g)
              .to(torch.bfloat16) for _ in range(2))
    table = torch.arange(b * n_pages, dtype=torch.int32).reshape(b, n_pages) \
        % p_total
    lengths = torch.tensor([3, 20, 9], dtype=torch.int32)
    want = ref.paged_attention_ref(q, kp, vp, table, lengths)
    c = cost.Cost()
    before = pa.launches
    with cost.counting(c):
        got = pa.paged_attention(*_meta(q, kp, vp, table, lengths))
    _same_shapes(got, want)
    assert pa.launches == before
    # no lengths to read on meta: every sequence at its whole table
    assert (c.flops, c.bytes) == cost.paged_attention_flops_bytes(
        b, h, hkv, d, b * n_pages * page, n_pages, 4, 2)


def test_gather_page_units_meta_branch():
    planes, p_total, page, d = 3, 16, 4, 8
    pool = torch.randn(planes, p_total, page, d)
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0], bool)
    units, _, _ = ops.compact_units(valid, 4)
    out = torch.zeros_like(pool)
    gc_compact.gather_page_units(pool, units, out)
    c = cost.Cost()
    before = gc_compact.launches
    with cost.counting(c):
        got = gc_compact.gather_page_units(pool.to(META), units,
                                           out.to(META))
    _same_shapes(got, out)
    assert gc_compact.launches == before
    assert (c.flops, c.bytes) == cost.gather_flops_bytes(
        int(valid.sum()), len(units), planes, page, d, 4)


def test_meta_branch_outside_a_counter_adds_nothing():
    q = torch.empty(1, 8, 2, 16, device=META, dtype=torch.bfloat16)
    assert fa.flash_attention(q, q, q).device.type == "meta"
    c = cost.Cost()
    with cost.counting(c):
        pass
    assert (c.flops, c.bytes, c.calls) == (0, 0, {})
