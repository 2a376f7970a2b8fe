#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[parallel dp]`` phase alone, on every card of this
machine: the kernels' build, then the train step across processes (one a
card, NCCL) at full olmo-1b width and the train driver under torchrun.

  python3 tools/parallel_dp.py [--model M]

On a host with four cards it runs world 4 (one process a card); on one
card it is the phase of the full script.  With ``--model M`` the mesh is
(cards / M, M): the same olmo-1b steps with tensor parallelism over the
model axis, then the mesh's full-width prefill (an f32 check against one
process, and a timed bf16 call) and a granite-moe-3b-a800m training step
with its experts split (``[parallel tp]`` lines); the train driver, which
runs the data axis only, is left out.  Exits non-zero where the phase
fails.
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
    args = ap.parse_args(argv)
    import chip_smoke
    if not chip_smoke.torch.cuda.is_available():
        chip_smoke.fail("no CUDA device is available")
    t = time.perf_counter()
    chip_smoke.phase_build()
    card = chip_smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader").splitlines()[0]
    paths = chip_smoke.phase_parallel_dp(card, args.model)
    print(f"[parallel] paths {paths}; wall with the build "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
