"""The port's execution across processes against its own one-process step,
on the CPU in gloo groups (``tests/torch_dist_worker.py``): the hybrid,
VLM and audio families, a batch that does not divide over the processes,
the gradient norm, the loss under masks that differ between processes,
the ``model`` axis, checkpoints that reshard on restore, and the train
driver under torchrun with crash and resume.

Tolerances are ``tests/test_torch_train.py``'s f32 ones (the loss to
1e-5 relative, the grad norm to 1e-4, params to 2·lr·steps at the worst
element and to 1e-5 at all but a 1e-3 share); jamba's f32 grad norm to
1e-2, as in ``tests/test_torch_hybrid.py`` (F7 at one block: its
gradient is ill conditioned, and the first AdamW step moves a param by
2·lr where a near-zero gradient changes sign).
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore, named_leaves
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, TrainConfig, build_train_step,
                               init_state, synthetic_batch)
from torch_dist_worker import SRC, run_ranks

SEQ, LR = 32, 1e-3


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, **kw)


def _batches(cfg, batch, steps):
    """synthetic_batch, with three position streams that differ under
    M-RoPE, (t, 2t, 3t) (ROADMAP F15)."""
    out = []
    for i in range(steps):
        b = synthetic_batch(cfg, i, batch, SEQ)
        if cfg.rope == "mrope":
            t = b["positions"][..., :1]
            b["positions"] = np.concatenate([t, 2 * t, 3 * t], axis=-1)
        out.append(b)
    return out


def _run(tmp_path, world, arch, batches, steps, microbatches=1, **kw):
    """The port's step in ``world`` processes and in this one, from the
    port's seeded init: (each rank's results, the one-process metrics and
    params)."""
    cfg = _cfg(arch, **kw)
    np.savez(tmp_path / "batches.npz", **{
        f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    overrides = dict(kw, compute_dtype="f32")
    ranks = run_ranks(world, {
        "kind": "train", "arch": arch, "overrides": overrides,
        "batch": len(batches[0]["targets"]), "seq": SEQ, "steps": steps,
        "microbatches": microbatches, "lr": LR,
        "batches": str(tmp_path / "batches.npz")}, tmp_path / "run")
    tc = TrainConfig(microbatches=microbatches, adamw=AdamWConfig(lr=LR))
    step, _ = build_train_step(cfg, len(batches[0]["targets"]), SEQ, tc,
                               "cpu")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_state(params, tc.adamw)
    want = {}
    for i, b in enumerate(batches[:steps]):
        params, opt, m = step(params, opt, b)
        want.update({f"{k}{i}": float(v) for k, v in m.items()})
    want.update({f"p/{k}": v.numpy() for k, v in named_leaves(params)})
    return ranks, want


def _check(got, want, steps, norm_tol=1e-4):
    for i in range(steps):
        assert abs(float(got[f"loss{i}"]) - want[f"loss{i}"]) <= \
            1e-5 * abs(want[f"loss{i}"]), i
        assert abs(float(got[f"grad_norm{i}"]) - want[f"grad_norm{i}"]) <= \
            norm_tol * want[f"grad_norm{i}"], i
    names = sorted(k for k in want if k.startswith("p/"))
    assert names == sorted(k for k in got if k.startswith("p/"))
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in names])
    assert float(diffs.max()) <= 2 * LR * steps
    assert float((diffs > 1e-5).mean()) <= 1e-3


@pytest.mark.parametrize("arch,layers", [("jamba-v0.1-52b", 8),
                                         ("qwen2-vl-2b", None),
                                         ("hubert-xlarge", None)])
def test_hybrid_vlm_and_audio_steps_on_2_processes(arch, layers, tmp_path):
    """2 steps at batch 4 on 2 processes against the one-process step: the
    hybrid (Mamba-2, attention and the MoE, globally routed), M-RoPE on
    three distinct streams, and the audio encoder's frames."""
    kw = {"n_layers": layers} if layers else {}
    cfg = _cfg(arch, **kw)
    ranks, want = _run(tmp_path, 2, arch, _batches(cfg, 4, 2), 2, **kw)
    _check(ranks[0], want, 2, 1e-2 if cfg.family == "hybrid" else 1e-4)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m"])
def test_a_batch_that_does_not_divide_is_replicated(arch, tmp_path):
    """Batch 6 on 4 processes: ``spec_for`` replicates it, as JAX does, and
    every process computes the whole batch (the MoE routes it without a
    gather).  Each process's gradient is then the one-process gradient, so
    the loss and the params after 2 steps are its bits; the grad norm adds
    the same squares in blocks (1e-6)."""
    cfg = _cfg(arch)
    ranks, want = _run(tmp_path, 4, arch, _batches(cfg, 6, 2), 2)
    for out in ranks:
        for i in range(2):
            assert float(out[f"loss{i}"]) == want[f"loss{i}"]
            assert abs(float(out[f"grad_norm{i}"]) - want[f"grad_norm{i}"]) \
                <= 1e-6 * want[f"grad_norm{i}"]
    for k in (k for k in want if k.startswith("p/")):
        assert np.array_equal(ranks[0][k], want[k]), k


def test_microbatches_over_2_processes(tmp_path):
    """mamba2-370m (replicated leaves) with microbatches=2 at batch 8 over
    2 processes: each microbatch's rows split again over the processes."""
    cfg = _cfg("mamba2-370m")
    ranks, want = _run(tmp_path, 2, "mamba2-370m", _batches(cfg, 8, 2), 2,
                       microbatches=2)
    _check(ranks[0], want, 2)


def test_global_norm_counts_a_replicated_leaf_once(tmp_path):
    """A split leaf (0..15 in blocks of 4) and a replicated one ((3, 4) on
    every process): √(Σ i² + 25), not √(Σ i² + 4·25)."""
    ranks = run_ranks(4, {"kind": "norm"}, tmp_path)
    want = float(np.sqrt(np.sum(np.arange(16.0) ** 2) + 25.0))
    for out in ranks:
        assert abs(float(out["norm"]) - want) <= 1e-6 * want


def test_loss_is_the_global_masked_mean(tmp_path):
    """olmo-1b at batch 8 over 4 processes, targets < 0 in most of the
    first process's rows and half the second's: the loss is the masked
    mean over the whole batch, as one process takes it, and not the mean
    of the processes' means, which the same batch puts 1e-3 away."""
    cfg = _cfg("olmo-1b")
    batches = _batches(cfg, 8, 2)
    for b in batches:
        b["targets"][0:2, 4:] = -1
        b["targets"][2:4, ::2] = -1
    ranks, want = _run(tmp_path, 4, "olmo-1b", batches, 2)
    _check(ranks[0], want, 2)
    # the mean of the four processes' own masked means is another number
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        means = [float(get_model(cfg).loss_fn(params, {
            k: torch.from_numpy(v[2 * r:2 * r + 2])
            for k, v in batches[0].items()}, cfg)) for r in range(4)]
    assert abs(np.mean(means) - want["loss0"]) > 1e-3 * want["loss0"]


def test_the_model_axis_is_not_executed(tmp_path):
    """In a group of 4, ``make_host_mesh(model=2)`` is (2, 2), and nothing
    on it is refused any more (the name is the one this test had while the
    mesh refused the model axis): every family's train, prefill and decode
    steps build and run once from the seeded init, each process on its
    blocks, with finite results (the decode from a zero cache of this
    process's blocks, ``init_cache_blocks``); hubert-xlarge, an encoder
    over frames, has no decode and raises its ValueError, as on one
    process.  ``tests/test_torch_tp.py``, ``test_torch_tp_ssm.py`` and
    ``test_torch_tp_decode.py`` hold the results against JAX."""
    archs = ["olmo-1b", "granite-moe-3b-a800m", "qwen2-vl-2b",
             "hubert-xlarge", "mamba2-370m", "jamba-v0.1-52b"]
    ranks = run_ranks(4, {"kind": "model_axis", "model": 2, "archs": archs,
                          "batch": 8, "seq": SEQ}, tmp_path)
    for out in ranks:
        assert tuple(out["mesh"]) == (2, 2)
        for arch in archs:
            for kind in ("train", "prefill", "decode"):
                said = str(out[f"raised/{arch}/{kind}"])
                if arch == "hubert-xlarge" and kind == "decode":
                    assert said.startswith("ValueError") \
                        and "no decode step" in said, said
                    continue
                assert said == "", (arch, kind, said)
                assert bool(out[f"finite/{arch}/{kind}"]), (arch, kind)


@pytest.fixture(scope="module")
def saved_on_4(tmp_path_factory):
    """One step of olmo-1b SMOKE on 4 processes, saved at step 1 by
    ``save_sharded``: (the directory, the whole state gathered)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    ranks = run_ranks(4, {"kind": "ckpt_save", "arch": "olmo-1b",
                          "batch": 8, "seq": SEQ, "dir": str(tmp / "store")},
                      tmp / "save")
    return tmp / "store", ranks[0]


def _same_state(got, want):
    names = sorted(k for k in want if k.startswith("s/"))
    assert names == sorted(k for k in got if k.startswith("s/"))
    assert any(k.startswith("s/opt/mu/") for k in names)
    for k in names:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("world", [2, 1])
def test_a_checkpoint_from_4_processes_restores_on_fewer(world, saved_on_4,
                                                         tmp_path):
    """``restore_sharded`` on 2 processes and on 1 (a group of one) fills
    each process's zero blocks; gathered, the whole state has the saved
    bits in every leaf of params, both moments and count."""
    store, want = saved_on_4
    ranks = run_ranks(world, {"kind": "ckpt_restore", "arch": "olmo-1b",
                              "batch": 8, "seq": SEQ, "dir": str(store)},
                      tmp_path)
    assert int(ranks[0]["step"]) == 1
    _same_state(ranks[0], want)


def test_a_checkpoint_from_4_processes_restores_in_one(saved_on_4):
    """The directory is the one-process store's: ``CheckpointStore`` reads
    the whole state back with the same bits."""
    store, want = saved_on_4
    step, flat = CheckpointStore(str(store), recover=True).restore()
    assert step == 1
    got = {f"s/{k}": v for k, v in flat.items()}
    for k, v in want.items():
        if k.startswith("s/") and v.dtype != got[k].dtype:
            got[k] = got[k].view(v.dtype)
    _same_state(got, want)


LOSS = re.compile(r"^step=(\d+) loss=(\S+) ")


def _torchrun(*args, world=4):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={world}", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--steps", "8", "--batch", "8",
         "--seq", str(SEQ), "--ckpt-every", "3", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


def test_train_driver_under_torchrun_crashes_and_resumes(tmp_path):
    """The driver in 4 processes: ``--fail-at 5`` exits 42 (torchrun
    reports 42 for the first process to exit and stops the others, which
    have all passed the failure's barrier), ``--resume`` prints
    ``resumed from step 5`` and the uninterrupted run's losses for steps 6
    and 7, and the two runs' last checkpoints hold the same bits.  Only
    rank 0 prints."""
    crash = _torchrun("--ckpt-dir", str(tmp_path / "a"), "--fail-at", "5")
    whole = _torchrun("--ckpt-dir", str(tmp_path / "b"))
    rc, out, err = _finish(crash)
    assert rc != 0 and "exitcode  : 42" in err, err[-3000:]
    codes = re.findall(r"exitcode\s*:\s*(-?\d+)", err)
    assert codes and set(codes) <= {"42", "-15"}, codes
    assert "simulated failure" in out
    assert [int(m.group(1)) for m in map(LOSS.match, out.splitlines())
            if m] == list(range(6))
    rc, out_b, err_b = _finish(whole)
    assert rc == 0, err_b[-3000:]
    rc, out_a, err_a = _finish(_torchrun("--ckpt-dir", str(tmp_path / "a"),
                                         "--resume"))
    assert rc == 0, err_a[-3000:]
    assert "resumed from step 5" in out_a

    def losses(text):
        return {int(m.group(1)): m.group(2)
                for m in map(LOSS.match, text.splitlines()) if m}
    assert losses(out_a) == {k: v for k, v in losses(out_b).items()
                             if k >= 6}
    assert out_b.count("training done") == 1
    got = CheckpointStore(str(tmp_path / "a"), recover=True).restore()
    want = CheckpointStore(str(tmp_path / "b"), recover=True).restore()
    assert got[0] == want[0] == 7
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        assert got[1][k].tobytes() == want[1][k].tobytes(), k


def test_parallel_dp_tool_refuses_to_run_without_a_card():
    """``tools/parallel_dp.py`` runs ``chip_smoke.py``'s ``[parallel dp]``
    phase on the cards; here, with none, it fails before doing anything."""
    tool = SRC.parent / "tools" / "parallel_dp.py"
    res = subprocess.run([sys.executable, str(tool)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device is available" in res.stderr
