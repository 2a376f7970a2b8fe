"""The port's dry-run (``repro_torch.launch.dryrun``) and the kernels' meta
branches, on the CPU.

The dry-run's exact fields (params, active params, devices, kind, model
flops per device) equal the JAX dry-run's, and its argument bytes lie
within 0.1% of XLA's, on the four cells where the JAX dry-run runs
(``tools/dryrun_compare.py``: two as shipped, train_4k and prefill_32k on
an Auto-axes mesh, ROADMAP F17).  Each kernel wrapper given meta tensors
returns its plain version's shapes and dtypes and adds exactly its
``kernels/cost.py`` formula; the meta counter, the collective terms and
the CLI are checked on hand-computed cases.
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

from repro.configs import ARCHS as J_ARCHS
from repro.launch import shapes as j_shapes
from repro_torch.configs import get_config
from repro_torch.kernels import cost, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gc_compact
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.models import get_model
from repro_torch.parallel.sharding import Mesh, default_rules
from repro_torch.train.step import _meta_params, step_specs

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
    assert got["cost"]["flops_per_dev"] > 0
    assert got["cost"]["hbm_bytes_per_dev"] > 0
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
    # one meta run serves both meshes, and both report its seconds
    first = json.loads((tmp_path / "mamba2_370m_long_500k_16x16.json")
                       .read_text())
    assert first["compile_s"] == written["compile_s"] > 0


def test_dryrun_meta_run_reaches_the_kernels_meta_branches(monkeypatch):
    """A chunked-attention transformer and Mamba-2 train step: K3 and
    K3-bwd, K4 and K4-bwd add their formulas, once a layer each (and K3
    and K4 once more a layer for the recompute under remat "full")."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), attn_impl="chunked"))
    r = dryrun.run_cell("olmo-1b", "train_4k", False, "")
    monkeypatch.undo()
    assert r["cost"]["kernel_calls"] == {"flash_attention": 32,
                                         "flash_attention_bwd": 16}
    r = dryrun.run_cell("mamba2-370m", "prefill_32k", False, "")
    assert r["cost"]["kernel_calls"] == {"ssd_scan": 48}


def test_meta_counter_counts_products_bytes_and_peak():
    a = torch.empty(4, 8, device=META)
    b = torch.empty(8, 16, device=META)
    counter = dryrun._MetaCounter()
    with counter:
        c = a @ b                          # 2·4·8·16 flops, 32+128+64 floats
        d = c.t()                          # a view: no bytes, no storage
        e = torch.empty(1000, device=META)  # an allocation: no bytes
        del e
        f = d + 1                          # 64 + 64 floats
    assert counter.flops == 2 * 4 * 8 * 16
    assert counter.bytes == 4 * (32 + 128 + 64) + 4 * (64 + 64)
    assert counter.peak == 4 * 1000 + 4 * 64
    assert counter.live == 4 * 64 * 2      # c (viewed by d) and f
    del c, d, f
    assert counter.live == 0


def test_collective_bytes_hand_computed():
    """olmo-1b SMOKE (2 layers, d_model 64, 4 heads of 16, ff 128, vocab
    256) training on a 2×2 (data, model) mesh, batch 4 × seq 8: f32
    params, bf16 activations."""
    cfg = get_config("olmo-1b", smoke=True)
    mesh = Mesh(("data", "model"), (2, 2))
    rules = default_rules(mesh)
    model = get_model(cfg)
    params = _meta_params(model.specs(cfg), cfg.param_dtype)
    (p_spec, _, _), _ = step_specs(cfg, "train", mesh, 4, 8, rules=rules)
    got = dryrun.collective_bytes(cfg, "train", mesh, rules, params, p_spec,
                                  model.logical_axes(cfg), 4, 8)
    # Every leaf is split over data (FSDP, 2 ways) and, but the norms, over
    # model: its shard in f32, gathered twice (forward, backward) to twice
    # its size, and its gradient's shard reduce-scattered once.
    shards = {"embed": 128 * 32, "unembed": 32 * 128, "final_norm": 32,
              "attn_norm": 2 * 32, "ffn_norm": 2 * 32,
              "wq": 2 * 32 * 2 * 16, "wk": 2 * 32 * 2 * 16,
              "wv": 2 * 32 * 2 * 16, "wo": 2 * 2 * 16 * 32,
              "ffn wi": 2 * 32 * 64, "ffn wg": 2 * 32 * 64,
              "ffn wo": 2 * 64 * 32}
    floats = sum(shards.values())
    # Tensor parallelism: attention's wo (heads) and the FFN's wo (mlp)
    # contract a model-split axis in each of 2 layers, forward and
    # backward: the local (2, 8, 64) bf16 activation each time; and two
    # (2, 8) f32 all-reduces for the vocab-split log-sum-exp.
    assert got == {"all-gather": 2 * 2 * 4 * floats,
                   "reduce-scatter": 4 * floats,
                   "all-reduce": 2 * 2 * 2 * (2 * 8 * 64 * 2)
                   + 2 * 2 * 8 * 4}


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
