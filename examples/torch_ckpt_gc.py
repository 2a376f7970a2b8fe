"""Checkpoint-GC example, on the PyTorch port: incremental checkpoints of
torch tensors on the Scavenger+ LSM store. Superseded tensor shards become
exposed garbage that the engine's GC reclaims, keeping the on-disk
footprint near keep_last x model size. The tree, the saves and the lines
printed are those of examples/ckpt_gc.py.

Run:  PYTHONPATH=src python examples/torch_ckpt_gc.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointStore
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = resolve_device(ap.parse_args().device)

store = CheckpointStore(None, CheckpointConfig(keep_last=2,
                                               engine="scavenger_plus"))
model_mb = 4
tree = {"layer0/w": torch.from_numpy(np.random.default_rng(0).normal(
            size=(model_mb * 131072,)).astype(np.float32)).to(device),
        "layer0/b": torch.zeros((1024,), dtype=torch.float32, device=device)}

print(f"model size ≈ {model_mb} MB, keep_last=2")
for step in range(0, 60, 10):
    tree["layer0/w"] = tree["layer0/w"] * 0.999 + step
    store.save(step, tree)
    store.db.flush_all()
    u = store.db.space_usage()
    amp = u["total_bytes"] / (2 * (model_mb << 20))
    print(f"step {step:2d}: kept={store.steps()} "
          f"disk={u['total_bytes'] / 1e6:6.1f} MB "
          f"(amp vs keep_last x model = {amp:.2f}) "
          f"garbage={u['global_garbage_ratio']:.2f} "
          f"gc_runs={store.db.stats_counters['gc_runs']:.0f}")

s, got = store.restore()
assert s == 50 and np.allclose(got["layer0/w"], tree["layer0/w"].cpu().numpy())
print("restore(latest) verified; GC held disk near 2x model size")
