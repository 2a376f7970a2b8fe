#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[parallel dp]`` phase alone, on every card of this
machine: the kernels' build, then the train step across processes (one a
card, NCCL) at full olmo-1b and mamba2-370m width, the decode step across
processes and the train driver under torchrun.

  python3 tools/parallel_dp.py [--model M] [--runs olmo,mamba,decode,...]

On a host with four cards it runs world 4 (one process a card); on one
card it is the phase of the full script.  With ``--model M`` the mesh is
(cards / M, M) (``[parallel tp]`` lines): the same olmo-1b steps with
tensor parallelism over the model axis; mamba2-370m's steps with its
Mamba-2 heads split (an f32 step at 2 layers against the f64 one-process
step, then timed full-width steps with K4 96 and K4-bwd 48 launches a
step on every card); the decode of olmo-1b (the KV cache split along its
sequence, merged by log-sum-exp) and of mamba2-370m (its heads' SSM state
split), each in f32 with its logits gathered against the one-process
decode, and timed in bf16; then the mesh's full-width prefill (an f32
check against one process, and a timed bf16 call) and a
granite-moe-3b-a800m training step with its experts split.  The train
driver, which runs the data axis only, is left out.  On 2 cards or more
(``pod``, model axis 1) an olmo-1b step on the (pod, data, model) mesh
(2, cards / 2, 1) is held to the data mesh's first loss on the same
batch; on 4 or more (``phi3``) phi3-medium-14b trains 3 steps at full
width on the mesh (global batch 4 × 4096): each rank's peak, each step's
time, K3 80 and K3-bwd 40 launches a step on every rank.  After olmo-1b's
timed and profiled steps, each rank counts the collectives of one more
step (calls and result bytes by kind, with the dry-run's counter), and
rank 0 prints them beside the dry-run's plan of the same rank, mesh and
global batch (``launch.dryrun.plan`` on meta tensors in a fake group,
computed in a subprocess before the group starts) and beside the NCCL
kernels of the profiled step; the two counts must be equal.  ``--runs``
takes a comma-separated subset of olmo, mamba, decode, prefill, granite,
pod, phi3 and driver (all by default; pod needs olmo).  Exits non-zero
where the phase fails.  On a host with four cards:

  python3 tools/parallel_dp.py --runs olmo,pod,phi3
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model axis (it must divide the cards)")
    ap.add_argument("--runs", default=None,
                    help="a comma-separated subset of olmo, mamba, decode, "
                         "prefill, granite, pod, phi3, driver (default: "
                         "all)")
    args = ap.parse_args(argv)
    import chip_smoke
    runs = chip_smoke.DP_RUNS
    if args.runs:
        runs = tuple(args.runs.split(","))
        unknown = set(runs) - set(chip_smoke.DP_RUNS)
        if unknown:
            ap.error(f"unknown runs {sorted(unknown)}; known: "
                     f"{', '.join(chip_smoke.DP_RUNS)}")
    if not chip_smoke.torch.cuda.is_available():
        chip_smoke.fail("no CUDA device is available")
    t = time.perf_counter()
    chip_smoke.phase_build()
    card = chip_smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader").splitlines()[0]
    paths = chip_smoke.phase_parallel_dp(card, args.model, runs)
    print(f"[parallel] paths {paths}; wall with the build "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
