"""The port's training slice against the JAX package, on the CPU: AdamW,
``build_train_step`` (with microbatches and remat) and the train driver.

Both packages start from JAX's init (carried over by ``params_from_numpy``)
and take the same numpy batches.  The JAX step is built on the mesh that
works with the installed JAX (ROADMAP F2): ``jax.make_mesh`` with Auto axes.

Tolerances.  f32: every product is taken in f32 on both sides and only the
order of the sums differs.  Losses agree to ~2e-7 relative (held to 1e-5),
grad norms to ~2e-5 (held to 1e-4), and each leaf's gradient to
‖Δg‖/‖g‖ ~4e-5 (held to 2e-4; the attention of the random init is nearly
one-hot, ROADMAP F7, which amplifies the rounding of the scores).  Params
after 3 steps: AdamW's first step is lr·g/(|g|+ε), so a gradient element
near 0 whose sign differs between the two frameworks moves a param by up
to 2·lr; params are held to 2·lr·steps at the worst element and to 1e-5 at
all but a 1e-3 share of them (measured: 7.8e-5 and 3.5e-5).  bf16: the two
frameworks round at different places and F7's nearly one-hot softmax turns
a rounded score into a different weight, so gradients differ by ~15% of
their norm (grad norms by up to ~47% after the params part); losses are
held to 2e-3 relative (measured ≤ 4.8e-4), grad norms to 60%, params to
10·lr at the worst element.
"""

import contextlib
import dataclasses
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.train import data as j_data
from repro.train import optimizer as j_opt
from repro.train import step as j_step
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.launch import train as t_train
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, TrainConfig, apply_updates,
                               build_train_step, init_state)
from repro_torch.train.optimizer import tree_leaves, tree_unflatten
from repro_torch.weights import params_from_numpy

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LR, STEPS, BATCH, SEQ = 1e-3, 3, 2, 32


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().float().numpy()
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _cfgs(arch, dtype, **kw):
    jc = dataclasses.replace(j_get_config(arch, smoke=True),
                             compute_dtype=JDT[dtype], **kw)
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype=TDT[dtype], **kw)
    return jc, tc


def _tree(rng, with_norm=True):
    tree = {"layers": {"w": rng.normal(size=(2, 8, 16)),
                       "b": rng.normal(size=(2, 16))},
            "unembed": rng.normal(size=(16, 32))}
    if with_norm:
        tree["final_norm"] = 1.0 + 0.1 * rng.normal(size=(16,))  # a gain
    return jax.tree.map(lambda x: x.astype(np.float32), tree)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_matches_jax(moments):
    """Per step, params and moments against repro.train.optimizer on a
    random tree with a 1-D norm gain (decayed too).  f32 moments: the same
    f32 arithmetic in the same order, held to 1e-6; bf16 moments are each
    rounded once from f32 values that may differ in the last bit, held to
    2^-8 relative, and the params they move to 1e-6."""
    rng = np.random.default_rng(0)
    jcfg = j_opt.AdamWConfig(lr=LR, moment_dtype=JDT[moments])
    tcfg = AdamWConfig(lr=LR, moment_dtype=TDT[moments])
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    tp = params_from_numpy(_tree(np.random.default_rng(0)), device="cpu")
    js, ts = j_opt.init_state(jp, jcfg), init_state(tp, tcfg)
    assert ts["count"].dtype == torch.int32
    for step in range(4):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape)
                             .astype(np.float32), _tree(rng))
        jp, js = j_opt.apply_updates(jp, jax.tree.map(jnp.asarray, grads),
                                     js, jcfg)
        tp, ts = apply_updates(tp, params_from_numpy(grads, device="cpu"),
                               ts, tcfg)
        assert int(ts["count"]) == int(js["count"]) == step + 1
        for got, want, tol in [(tp, jp, 1e-6), (ts["mu"], js["mu"], None),
                               (ts["nu"], js["nu"], None)]:
            tol = tol or (1e-6 if moments == "f32" else 2 ** -8)
            g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
            assert sorted(g) == sorted(w)
            for name in w:
                np.testing.assert_allclose(g[name], w[name], rtol=tol,
                                           atol=tol, err_msg=name)
    moments_dtype = {t.dtype for t in
                     tree_leaves(ts["mu"]) + tree_leaves(ts["nu"])}
    assert moments_dtype == {TDT[moments]}
    # the gain was decayed: with lr·wd·p in every step it moved off 1 + noise
    assert not np.allclose(_flat(tp)["final_norm"],
                           _tree(np.random.default_rng(0))["final_norm"])


def _batch(cfg, step, b, s):
    """synthetic_batch, with three position streams that differ under
    M-RoPE, (t, 2t, 3t): the batch repeats one stream, on which M-RoPE is
    RoPE at theta 1e6."""
    batch = j_data.synthetic_batch(cfg, step, b, s)
    if cfg.rope == "mrope":
        t = batch["positions"][..., :1]
        batch["positions"] = np.concatenate([t, 2 * t, 3 * t], axis=-1)
    return batch


def _run_both(arch, dtype, impl, microbatches=1, resync=False, **kw):
    """STEPS train steps of the JAX step and of the port's from JAX's init;
    returns ([(jax metrics, port metrics)], jax params, port params).  With
    ``resync`` the port takes JAX's params and moments before every step,
    so that each step starts from one state."""
    jc, tc = _cfgs(arch, dtype, attn_impl=impl, **kw)
    jp = j_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    adamw = j_opt.AdamWConfig(lr=LR)
    fn, in_sh, out_sh, _ = j_step.build_train_step(
        jc, _mesh(), BATCH, SEQ, j_step.TrainConfig(microbatches=microbatches,
                                                    adamw=adamw))
    jstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    tcfg = TrainConfig(microbatches=microbatches, adamw=AdamWConfig(lr=LR))
    tstep, _ = build_train_step(tc, BATCH, SEQ, tcfg, "cpu")
    jo, to = j_opt.init_state(jp, adamw), init_state(tp, tcfg.adamw)
    metrics = []
    for i in range(STEPS):
        if resync:
            tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
            to = params_from_numpy(jax.tree.map(np.asarray, jo),
                                   device="cpu")
            to["count"] = to["count"].to(torch.int32)
            to["mu"], to["nu"] = (tree_unflatten(to[k], [
                x.to(tcfg.adamw.moment_dtype) for x in tree_leaves(to[k])])
                for k in ("mu", "nu"))
        batch = _batch(jc, i, BATCH, SEQ)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    assert int(to["count"]) == STEPS
    return metrics, jax.tree.map(np.asarray, jp), tp


TRAIN_CASES = [(arch, impl, dtype)
               for arch in ["olmo-1b", "starcoder2-3b"]
               for impl in ["naive", "chunked"]
               for dtype in ["f32", "bf16"]] + \
    [("mamba2-370m", "naive", dtype) for dtype in ["f32", "bf16"]] + \
    [(arch, "chunked", dtype)
     for arch in ["granite-moe-3b-a800m", "grok-1-314b", "qwen2-vl-2b"]
     for dtype in ["f32", "bf16"]] + \
    [("hubert-xlarge", "naive", dtype) for dtype in ["f32", "bf16"]]


@pytest.mark.parametrize("arch,impl,dtype", TRAIN_CASES)
def test_train_step_matches_jax(arch, impl, dtype):
    """3 steps at batch 2, seq 32, lr 1e-3: loss and grad norm each step,
    params after the last (tolerances in the module docstring).  On the
    CPU the chunked branch runs K3's plain forward and backward; mamba2's
    scan goes through SSDScan, the plain chunked forward and its plain
    backward (``ref.ssd_chunked_bwd_ref``)."""
    _check_train_steps(*_run_both(arch, dtype, impl), dtype)


@pytest.mark.parametrize("n_layers", [pytest.param(8, id="1block"),
                                      pytest.param(16, id="2blocks")])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hybrid_train_step_matches_jax(dtype, n_layers):
    """jamba-v0.1-52b, 3 steps at one and two blocks, each from JAX's
    state (``resync``).  On independent trajectories the f32 grad norms
    part by ~2% at step 1 (one block): AdamW's first step moves every
    param whose gradient sign differs between the frameworks by 2·lr, and
    under F7's std-1 weights that is a large move.  From one state the
    loss agrees to ~1e-7 and is held to 1e-5, but the gradient is ill
    conditioned: at the state entering step 2 (two blocks) scaling every
    param by 1 ± 2^-23 moves the port's own grad norm by up to 9.6e-4
    relative, with no token routed differently, and JAX's lies 1.9e-3
    from the port's.  So the f32 grad norm is held to 1e-2 here (1e-4
    for the other models); bf16 and the params as in
    test_train_step_matches_jax."""
    _check_train_steps(*_run_both("jamba-v0.1-52b", dtype, "chunked",
                                  resync=True, n_layers=n_layers), dtype,
                       norm_tol=1e-2 if dtype == "f32" else None)


def _check_train_steps(metrics, jp, tp, dtype, norm_tol=None):
    loss_tol, default_tol, worst = ((1e-5, 1e-4, 2 * LR * STEPS)
                                    if dtype == "f32"
                                    else (2e-3, 0.6, 10 * LR))
    norm_tol = norm_tol or default_tol
    for jm, tm in metrics:
        assert np.isfinite(tm["loss"]) and np.isfinite(tm["grad_norm"])
        assert abs(tm["loss"] - jm["loss"]) <= loss_tol * abs(jm["loss"])
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= \
            norm_tol * jm["grad_norm"]
    got, want = _flat(tp), _flat(jp)
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert float(diffs.max()) <= worst
    if dtype == "f32":
        assert float((diffs > 1e-5).mean()) <= 1e-3


def _grads_against_jax(jc, tc):
    """Loss and each leaf's gradient of the port against
    jax.value_and_grad of the JAX loss, in f32, at ‖Δg‖/‖g‖ ≤ 2e-4; leaves
    the loss does not read (olmo's norm gains) get zeros on both sides."""
    jp = j_get_model(jc).init(jc, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = _batch(jc, 0, BATCH, SEQ)
    jloss, jg = jax.value_and_grad(j_get_model(jc).loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss = get_model(tc).loss_fn(tree_unflatten(tp, leaves),
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, tc)
    tg = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    got, want = _flat(tree_unflatten(tp, tg)), _flat(jax.tree.map(np.asarray,
                                                              jg))
    for name, w in want.items():
        norm = float(np.linalg.norm(w))
        if norm == 0.0:
            assert not got[name].any(), name
            continue
        assert float(np.linalg.norm(got[name] - w)) <= 2e-4 * norm, name


@pytest.mark.parametrize("arch,impl", [("olmo-1b", "naive"),
                                       ("olmo-1b", "chunked"),
                                       ("starcoder2-3b", "chunked"),
                                       ("mamba2-370m", "naive"),
                                       ("granite-moe-3b-a800m", "chunked"),
                                       ("grok-1-314b", "naive"),
                                       ("qwen2-vl-2b", "chunked"),
                                       ("hubert-xlarge", "naive")])
def test_grads_match_jax(arch, impl):
    """Each leaf's gradient against jax.value_and_grad of the JAX loss."""
    _grads_against_jax(*_cfgs(arch, "f32", attn_impl=impl))


def test_microbatches_match_jax():
    """microbatches=2 against JAX's microbatches=2 (f32 tolerances), and
    against the port's own microbatches=1: the same mean loss and mean
    gradient, summed in another order (1e-5 relative)."""
    metrics, jp, tp = _run_both("olmo-1b", "f32", "chunked", microbatches=2)
    for jm, tm in metrics:
        assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= \
            1e-4 * jm["grad_norm"]
    one, _, _ = _run_both("olmo-1b", "f32", "chunked", microbatches=1)
    for (_, m2), (_, m1) in zip(metrics, one):
        assert abs(m2["loss"] - m1["loss"]) <= 1e-5 * abs(m1["loss"])
        assert abs(m2["grad_norm"] - m1["grad_norm"]) <= \
            1e-5 * m1["grad_norm"]


@pytest.mark.parametrize("arch,impl", [
    pytest.param("olmo-1b", "naive", id="naive"),
    pytest.param("olmo-1b", "chunked", id="chunked"),
    pytest.param("mamba2-370m", "naive", id="mamba2-370m")])
def test_remat_full_gives_the_same_grads(arch, impl):
    """remat="full" runs each layer again in the backward pass: on the CPU
    the recomputed forward is the same arithmetic, so one step gives the
    same loss and grad norm to the last bit, and params within 1e-7.  For
    mamba2 the layer's scan goes through SSDScan (the plain forward, again
    under remat, and the plain backward)."""
    _, tc = _cfgs(arch, "f32", attn_impl=impl)
    out = {}
    for remat in ["none", "full"]:
        cfg = dataclasses.replace(tc, remat=remat)
        params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        step, _ = build_train_step(cfg, BATCH, SEQ,
                                   TrainConfig(adamw=AdamWConfig(lr=LR)),
                                   "cpu")
        batch = j_data.synthetic_batch(cfg, 0, BATCH, SEQ)
        params, _, m = step(params, init_state(params, AdamWConfig()), batch)
        out[remat] = (m, _flat(params))
    (m0, p0), (m1, p1) = out["none"], out["full"]
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for name in p0:
        np.testing.assert_allclose(p1[name], p0[name], rtol=1e-7, atol=1e-7)


def test_remat_policy_not_ported_raises_only_under_grad():
    """The transformer's "dots_with_no_batch_dims" policy (the reference
    saves the products without batch dims) is not yet ported: the forward
    runs, a gradient raises."""
    _, tc = _cfgs("olmo-1b", "f32")
    cfg = dataclasses.replace(tc, remat="dots_with_no_batch_dims")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in j_data.synthetic_batch(cfg, 0, 1, 16).items()}
    with torch.no_grad():          # the loop is unchanged: runs
        assert model.forward(params, batch, cfg).shape == (1, 16, cfg.vocab)
    params["unembed"].requires_grad_()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model.loss_fn(params, batch, cfg)


def test_mamba2_remat_policy_other_than_full_runs_plain():
    """The Mamba-2 reference checkpoints only under remat="full" and runs
    every other policy plain, so the port does too: loss and gradients
    under "dots_with_no_batch_dims" against jax.value_and_grad."""
    _grads_against_jax(*_cfgs("mamba2-370m", "f32",
                              remat="dots_with_no_batch_dims"))


def _abstract(tree):
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), str(tree.dtype)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "qwen2-vl-2b", "hubert-xlarge"])
def test_train_step_inputs_match_jax(arch):
    jc, tc = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    *_, want = j_step.build_train_step(jc, _mesh(), 4, 16)
    _, got = build_train_step(tc, 4, 16, device="cpu")
    assert _abstract(dict(enumerate(got))) == \
        _abstract(dict(enumerate(want)))


def test_grad_compression_is_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_train_step(get_config("olmo-1b", smoke=True), 2, 8,
                         TrainConfig(grad_compression=True), "cpu")


DRIVER = ["--device", "cpu", "--smoke", "--batch", "2", "--seq", "32"]
# The JAX driver's step line (src/repro/launch/train.py).
STEP_LINE = re.compile(r"step=(\d+) loss=(\d+\.\d{4}) dt=\d+ms( STRAGGLER)?")


def _driver(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_train.main(argv)
    return rc, buf.getvalue().splitlines()


def test_train_driver_prints_the_jax_driver_lines():
    _check_driver_lines("olmo-1b")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b"])
def test_train_driver_runs_the_moe_archs(arch):
    _check_driver_lines(arch)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-vl-2b",
                                  "hubert-xlarge"])
def test_train_driver_runs_the_hybrid_vlm_and_audio_archs(arch):
    _check_driver_lines(arch)


def _check_driver_lines(arch):
    rc, lines = _driver(DRIVER + ["--arch", arch, "--steps", "3"])
    assert rc == 0 and lines[-1] == "training done"
    steps = [STEP_LINE.fullmatch(line) for line in lines[:-1]]
    assert all(steps) and [int(s.group(1)) for s in steps] == [0, 1, 2]
    # the losses are those of build_train_step from init with seed 0
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step, _ = build_train_step(cfg, 2, 32, tcfg, "cpu")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    opt = init_state(params, tcfg.adamw)
    for i, s in enumerate(steps):
        params, opt, m = step(params, opt,
                              j_data.synthetic_batch(cfg, i, 2, 32))
        assert s.group(2) == f"{float(m['loss']):.4f}"


def test_train_driver_fail_at_exits_42():
    rc, lines = _driver(DRIVER + ["--steps", "5", "--fail-at", "1"])
    assert rc == 42
    assert lines[-1].startswith("simulated failure")
    assert len(lines) == 3 and "training done" not in lines


def _steps(lines):
    return [int(m.group(1)) for m in map(STEP_LINE.fullmatch, lines) if m]


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "granite-moe-3b-a800m", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_train_driver_crash_resume_replays_identically(arch, tmp_path):
    """Crash after step 5 (saves after steps 2 and 5), resume, and end
    with the same bits in every leaf as a run never interrupted."""
    base = DRIVER + ["--arch", arch, "--steps", "8", "--ckpt-every", "3"]
    crashed, whole = str(tmp_path / "crashed"), str(tmp_path / "whole")
    rc, lines = _driver(base + ["--ckpt-dir", crashed, "--fail-at", "5"])
    assert rc == 42 and _steps(lines) == [0, 1, 2, 3, 4, 5]
    assert lines[-1].startswith("simulated failure")
    assert CheckpointStore(crashed, recover=True).steps() == [2, 5]
    rc, resumed = _driver(base + ["--ckpt-dir", crashed, "--resume"])
    assert rc == 0 and resumed[0] == "resumed from step 5"
    assert _steps(resumed) == [6, 7] and resumed[-1] == "training done"
    rc, full = _driver(base + ["--ckpt-dir", whole])
    assert rc == 0 and _steps(full) == list(range(8))
    loss = {int(m.group(1)): m.group(2)
            for m in map(STEP_LINE.fullmatch, lines + full) if m}
    for line in resumed[1:3]:
        m = STEP_LINE.fullmatch(line)
        assert m.group(2) == loss[int(m.group(1))], line
    a = CheckpointStore(crashed, recover=True)
    b = CheckpointStore(whole, recover=True)
    assert a.steps() == b.steps() == [5, 7]
    (sa, got), (sb, want) = a.restore(), b.restore()
    assert sa == sb == 7 and sorted(got) == sorted(want)
    assert {n.split("/")[0] for n in got} == {"params", "opt"}
    assert int(got["opt/count"]) == 8
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_train_driver_refuses_a_store_without_resume(tmp_path):
    """A run without --resume into a directory that holds a store is
    refused and writes nothing there (a fresh store over the old one
    would leave a later recovery replaying the first run's manifest);
    --resume then continues from the latest checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    rc, _ = _driver(DRIVER + ["--steps", "3", "--ckpt-every", "2",
                              "--ckpt-dir", ckpt])
    assert rc == 0
    files = {f: os.path.getsize(os.path.join(ckpt, f))
             for f in os.listdir(ckpt)}
    with pytest.raises(SystemExit) as refused:
        _driver(DRIVER + ["--steps", "5", "--ckpt-dir", ckpt])
    assert refused.value.code == 2
    assert {f: os.path.getsize(os.path.join(ckpt, f))
            for f in os.listdir(ckpt)} == files
    rc, lines = _driver(DRIVER + ["--steps", "5", "--ckpt-dir", ckpt,
                                  "--resume"])
    assert rc == 0 and lines[0] == "resumed from step 2"
    assert _steps(lines) == [3, 4] and lines[-1] == "training done"
    assert CheckpointStore(ckpt, recover=True).steps() == [2, 4]


def test_train_driver_resume_on_an_empty_directory_starts_at_0(tmp_path):
    ckpt = str(tmp_path / "empty")
    rc, lines = _driver(DRIVER + ["--steps", "2", "--ckpt-dir", ckpt,
                                  "--resume"])
    assert rc == 0 and _steps(lines) == [0, 1]
    assert not any(line.startswith("resumed") for line in lines)
    assert CheckpointStore(ckpt, recover=True).steps() == [1]
