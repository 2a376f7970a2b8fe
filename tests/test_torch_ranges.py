"""The port's profiler ranges (``repro_torch.ranges``) on the CPU: one
SMOKE-size training step under remat "full", profiled.

Each matrix product (``aten::mm``, ``bmm``, ``addmm``) must have as its
innermost range the (part, pass) that the profiler's own records give it,
independently of the ranges: the part from the product's shapes (the
vocabulary's width is the unembedding's, d_ff's the FFN's; at SMOKE size
no other product has either), the pass from the autograd engine (an op
inside an autograd node's event runs in the backward pass: where it, or
an op or autograd Function around it inside that node, has a sequence
number, it records a graph, so it is the remat recompute; else it is a
gradient op).  The profiler must change no bit, and with it off,
or with grad off, the helper must add no autograd node.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import ranges
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.train import (TrainConfig, build_prefill_step,
                               build_train_step, init_state, synthetic_batch)
from repro_torch.train.optimizer import (clone_tree, tree_leaves,
                                         tree_unflatten)

B, S = 2, 32
PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm")
BACKWARD_FUNCTION = 1          # torch's RecordScope of an autograd node
# the mixer (attention or Mamba-2) and the FFN's parts, where there is one
MIXERS = {"olmo-1b": ("attention", "ffn"), "mamba2-370m": ("mamba",)}
MARKERS = ("_OpenBackward", "_CloseBackward")


def _setup(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    return cfg, params, synthetic_batch(cfg, 0, B, S)


def _expected(cfg, e):
    """(part, pass) of a product event, from the profiler's records."""
    dims = {d for shape in e.input_shapes for d in shape}
    if cfg.vocab in dims:
        part = "unembed"
    elif cfg.family == "ssm":
        part = "mamba"
    else:
        part = "ffn" if cfg.d_ff in dims else "attention"
    graph, up = e.sequence_nr >= 0, e.cpu_parent
    while up is not None and up.scope != BACKWARD_FUNCTION:
        graph |= up.sequence_nr >= 0
        up = up.cpu_parent
    if up is None:
        return part, "forward"
    return part, "remat" if graph else "bwd"


def _innermost(e):
    up = e.cpu_parent
    while up is not None and up.name not in ranges.NAMES:
        up = up.cpu_parent
    return None if up is None else ranges.split(up.name)


def _range_events(events):
    return [e for e in events if e.name in ranges.NAMES]


@pytest.fixture(scope="module", params=sorted(MIXERS))
def traced_step(request):
    """(arch, cfg, the profiled step's events, the plain and the profiled
    step's outputs from one state)."""
    cfg, params, batch = _setup(request.param)
    tc = TrainConfig()
    step, _ = build_train_step(cfg, B, S, tc, device="cpu")
    opt = init_state(params, tc.adamw)
    plain = step(clone_tree(params), clone_tree(opt), batch)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        traced = step(params, opt, batch)
    return request.param, cfg, prof.events(), plain, traced


def test_each_part_runs_once_a_layer_in_each_pass(traced_step):
    arch, cfg, events, _, _ = traced_step
    names = [e.name for e in _range_events(events)]
    for part in MIXERS[arch] + ("layer",):
        for suffix in ranges.PASSES:
            assert names.count(part + suffix) == cfg.n_layers, part + suffix
    for part in ("embed", "unembed", "loss"):
        assert [names.count(part + s) for s in ranges.PASSES] == [1, 0, 1]
    for part in ("grad_norm", "adamw"):
        assert [names.count(part + s) for s in ranges.PASSES] == [1, 0, 0]


def test_ranges_nest_on_each_thread(traced_step):
    _, _, events, _, _ = traced_step
    by_thread = {}
    for e in _range_events(events):
        by_thread.setdefault(e.thread, []).append(
            (e.time_range.start, -e.time_range.end, e.name))
    for spans in by_thread.values():
        open_ends = []
        for start, minus_end, name in sorted(spans):
            while open_ends and open_ends[-1] <= start:
                open_ends.pop()
            # inside every range still open, or a range that never closed
            assert not open_ends or -minus_end <= open_ends[-1], name
            open_ends.append(-minus_end)
    # a remat recompute runs inside the backward of the layer's last part
    remat = [e for e in events if e.name.endswith(".remat")]
    assert remat and all(_innermost(e) is not None
                         and _innermost(e)[1] in ("bwd", "remat")
                         for e in remat)


def test_each_product_falls_in_its_part_and_pass(traced_step):
    _, cfg, events, _, _ = traced_step
    products = [e for e in events if e.name in PRODUCTS]
    assert products
    wrong = [(e.name, _expected(cfg, e), _innermost(e)) for e in products
             if _innermost(e) != _expected(cfg, e)]
    assert not wrong, wrong[:5]
    got = {_innermost(e)[1] for e in products}
    assert got == {"forward", "remat", "bwd"}


def test_the_profiler_changes_no_bit_of_the_step(traced_step):
    *_, plain, traced = traced_step
    a, b = (tree_leaves(dict(zip(("params", "opt", "metrics"), out)))
            for out in (plain, traced))
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _marker_nodes(loss):
    seen, stack, found = set(), [loss.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node.name() in MARKERS:
            found.append(node.name())
        stack.extend(n for n, _ in node.next_functions)
    return found


def _loss_and_grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    loss = get_model(cfg).loss_fn(
        tree, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, grads


@pytest.mark.parametrize("arch", sorted(MIXERS))
def test_markers_only_under_the_profiler(arch):
    """The loss's graph holds two marker nodes a part instance under the
    profiler and none without it; loss and gradients are the same bits."""
    cfg, params, batch = _setup(arch)
    loss, grads = _loss_and_grads(cfg, params, batch)
    assert _marker_nodes(loss) == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced_loss, traced_grads = _loss_and_grads(cfg, params, batch)
        # embed, unembed, loss, and each layer's parts
        parts = 3 + cfg.n_layers * (1 + len(MIXERS[arch]))
        assert len(_marker_nodes(traced_loss)) == 2 * parts
    assert torch.equal(loss, traced_loss)
    assert all(torch.equal(x, y) for x, y in zip(grads, traced_grads))


@pytest.mark.parametrize("arch", sorted(MIXERS))
def test_prefill_under_no_grad_makes_no_marker(arch, monkeypatch):
    cfg, params, batch = _setup(arch)
    batch.pop("targets")
    made = []
    for fn in (ranges._Open, ranges._Close):
        monkeypatch.setattr(fn, "apply", lambda *a, _f=fn.apply:
                            made.append(1) or _f(*a))
    step, _ = build_prefill_step(cfg, B, S, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, batch)
    names = {e.name for e in _range_events(prof.events())}
    assert made == []
    assert MIXERS[arch][0] in names
    assert all(ranges.split(n)[1] == "forward" for n in names)


def test_range_names_split_into_part_and_pass():
    assert ranges.split("attention") == ("attention", "forward")
    assert ranges.split("moe.route.remat") == ("moe.route", "remat")
    assert ranges.split("ffn.bwd") == ("ffn", "bwd")
    assert len(set(ranges.NAMES)) == 3 * len(ranges.PARTS)
