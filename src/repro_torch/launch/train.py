"""Training driver: synthetic batches through ``build_train_step``, with
per-step wall time and straggler detection.

* straggler detection: per-step wall-time EWMA; steps slower than
  ``straggler_factor``x the EWMA are logged;
* checkpoint/restart on the LSM-backed store: with ``--ckpt-dir`` the
  params and AdamW state are saved after every ``--ckpt-every``-th step
  and after the last; ``--resume`` restores the latest durable step into
  the state on the device and continues from the step after it;
* ``--fail-at`` simulates a crash after that step, and after that step's
  save (exit code 42).

Two departures from the JAX driver.  It opens the store with
``recover=False`` even under ``--resume``, and a store so opened over an
existing directory does not replay its manifest, so its ``--resume``
restores nothing and starts again from step 0.  Here ``--resume`` on a
directory that holds a store (``*.blk`` files) opens it with
``recover=True``; a directory without one is opened fresh
(``recover=True`` there raises, as there is no manifest to replay) and
training starts at step 0.  And it opens a fresh store over a directory
that already holds one: the new manifest lies beside the old, and a
later recovery replays the old.  Here, without ``--resume``, such a
directory is refused.

Across processes: started by torchrun, one process a device (a card, or
the CPU with ``--device cpu``), the driver runs the train step on the
mesh of all of them, ``--batch`` being the global batch: the processes
split its rows and hold params and AdamW moments as FSDP blocks
(``train/step.py``).  Each starts from the same init and keeps its block.
A checkpoint holds whole tensors, written by rank 0 in the directory
format of one process, so a run resumes on any number of processes.
Only rank 0 prints; ``--fail-at`` exits 42 in every process.  Without
torchrun's variables it is the one-process driver.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --steps 20 --batch 8 --seq 128 --ckpt-dir DIR [--resume] \
      [--fail-at 7] [--device cuda]
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --smoke ... [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint import (CheckpointConfig, CheckpointStore,
                          restore_sharded, save_sharded)
from ..configs import get_config
from ..device import resolve_device
from ..models import get_model
from ..parallel import runtime
from ..train.data import synthetic_batch
from ..train.optimizer import AdamWConfig, init_state
from ..train.step import TrainConfig, build_train_step, step_specs
from .mesh import make_host_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash after this step")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not runtime.launched_by_torchrun():
        return run(ap, args, resolve_device(args.device))
    device = runtime.init_group(args.device)
    try:
        return run(ap, args, device)
    finally:
        dist.destroy_process_group()


def run(ap, args, device) -> int:
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = make_host_mesh(device=device)
    rank0 = runtime.rank(mesh) == 0
    say = print if rank0 else (lambda *a, **k: None)
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step_fn, _ = build_train_step(cfg, args.batch, args.seq, tc, device,
                                  mesh=mesh)
    (p_spec, opt_spec, _), _ = step_specs(cfg, "train", mesh, args.batch,
                                          args.seq, tc)
    specs = {"params": p_spec, "opt": opt_spec}
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device).manual_seed(0), device)
    params = runtime.shard_tree(params, p_spec, mesh)
    opt = init_state(params, tc.adamw)
    start_step = 0
    store = None

    if args.ckpt_dir:
        recover = os.path.isdir(args.ckpt_dir) and any(
            name.endswith(".blk") for name in os.listdir(args.ckpt_dir))
        if recover and not args.resume:
            ap.error(f"--ckpt-dir {args.ckpt_dir} holds a checkpoint store: "
                     "pass --resume to continue it, or an empty directory")
        # every process has looked at the directory before rank 0 opens the
        # store in it
        runtime.barrier(mesh)
        if rank0:
            store = CheckpointStore(args.ckpt_dir,
                                    CheckpointConfig(keep_last=2),
                                    recover=recover)
        if args.resume:
            step, state = restore_sharded(
                store, {"params": params, "opt": opt}, specs, mesh)
            if step is not None:
                params, opt = state["params"], state["opt"]
                start_step = step + 1
                say(f"resumed from step {step}", flush=True)

    ewma = None
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, step, args.batch, args.seq)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.8 * ewma + 0.2 * dt
        straggler = dt > args.straggler_factor * ewma and step > start_step
        say(f"step={step} loss={loss:.4f} dt={dt * 1e3:.0f}ms"
            + (" STRAGGLER" if straggler else ""), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_sharded(store, step, {"params": params, "opt": opt}, specs,
                         mesh, extra={"loss": loss})
        if args.fail_at is not None and step == args.fail_at:
            say("simulated failure — exiting uncleanly", flush=True)
            # every process fails at this step: none leaves before all have
            # reached it (torchrun stops the others once one exits)
            runtime.barrier(mesh)
            return 42
    if args.ckpt_dir:
        save_sharded(store, args.steps - 1, {"params": params, "opt": opt},
                     specs, mesh)
    say("training done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
