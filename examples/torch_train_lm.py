"""End-to-end training driver example, on the PyTorch port: the dense LM
of examples/train_lm.py trained with LSM-backed checkpointing and crash
recovery, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--device cpu] [--ckpt-dir DIR]
(Use --steps 20 for a quick look; the model is a width-reduced OLMo.)
Without ``--ckpt-dir`` the checkpoints go to a new temporary directory,
removed at the end; a ``--ckpt-dir`` that already holds a store is
refused by the driver.
"""

import argparse
import shutil
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        rc = train_main([
            "--arch", "olmo-1b", "--smoke",          # reduced config family
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "256",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "25",
            "--device", args.device,
        ])
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    sys.exit(rc)


if __name__ == "__main__":
    run()
