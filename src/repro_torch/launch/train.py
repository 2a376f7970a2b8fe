"""Training driver: synthetic batches through ``build_train_step``, with
per-step wall time and straggler detection.

* straggler detection: per-step wall-time EWMA; steps slower than
  ``straggler_factor``x the EWMA are logged;
* ``--fail-at`` simulates a crash after that step (exit code 42).

Checkpoint/restart (``--ckpt-dir``, ``--ckpt-every``, ``--resume``) is not
yet ported: the flags are accepted and refused.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --steps 20 --batch 8 --seq 128 [--fail-at 7] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import get_model
from ..train.data import synthetic_batch
from ..train.optimizer import AdamWConfig, init_state
from ..train.step import TrainConfig, build_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="(5 in the JAX driver) not yet ported")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash after this step")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None or args.ckpt_every is not None \
            or args.resume:
        raise NotImplementedError("checkpointing is not yet ported")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step_fn, _ = build_train_step(cfg, args.batch, args.seq, tc, device)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device).manual_seed(0), device)
    opt = init_state(params, tc.adamw)

    ewma = None
    for step in range(args.steps):
        batch = synthetic_batch(cfg, step, args.batch, args.seq)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.8 * ewma + 0.2 * dt
        straggler = dt > args.straggler_factor * ewma and step > 0
        print(f"step={step} loss={loss:.4f} dt={dt * 1e3:.0f}ms"
              + (" STRAGGLER" if straggler else ""), flush=True)
        if args.fail_at is not None and step == args.fail_at:
            print("simulated failure — exiting uncleanly", flush=True)
            return 42
    print("training done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
