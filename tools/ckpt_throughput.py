#!/usr/bin/env python3
"""The checkpoint store's save, recovery and restore rates over several
saves, on the machine of one NVIDIA card.

  python3 tools/ckpt_throughput.py [--saves 3]

Runs ``chip_smoke.py``'s ``phase_checkpoint_throughput`` with more saves
than the smoke run takes: the full-width mamba2-370m training state (f32
params after one train step on the card, both AdamW moments, the count)
cut to 2 of its 48 layers, saved ``--saves`` times into one
store with ``keep_last=2``, then recovered and restored into card
tensors.  Prints each save's time and rate, the bytes on disk, the
engine's garbage ratio and GC runs, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--saves", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader").splitlines()[0]
    chip_smoke.phase_checkpoint_throughput(card, saves=args.saves)
    return 0


if __name__ == "__main__":
    sys.exit(main())
