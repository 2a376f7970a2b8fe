#!/usr/bin/env python3
"""The port's dry-run (``repro_torch.launch.dryrun``) beside the JAX
package's (``repro.launch.dryrun``), on the CPU, on the 16x16 mesh, for
the four cells where the JAX dry-run runs under JAX 0.9.0.

  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_compare.py

The JAX dry-run runs in a subprocess with 512 host devices.
``olmo-1b decode_32k`` and ``mamba2-370m long_500k`` run as shipped; its
``train_4k`` and ``prefill_32k`` cells fail there (their
``make_production_mesh`` builds Explicit axes, which
``with_sharding_constraint`` refuses), so for those the subprocess builds
the same mesh with Auto axes in its place; nothing in ``src/repro``
changes.  Prints, per cell, each side's flops, HBM bytes and collective
bytes per device and argument bytes, and the port's over the JAX
package's.  The JAX numbers are XLA's cost analysis for the TPU v5e
target's compile on host devices, not a measurement; the port's are
counts on meta tensors.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
# (arch, shape, whether the JAX run needs the Auto-axes mesh)
CELLS = [("olmo-1b", "decode_32k", False), ("mamba2-370m", "long_500k", False),
         ("olmo-1b", "train_4k", True), ("olmo-1b", "prefill_32k", True)]

_REFERENCE = """
import json, sys
import jax
from jax.sharding import AxisType
import repro.launch.mesh as mesh_mod
from repro.launch import dryrun

shipped = mesh_mod.make_production_mesh


def auto_axes(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


out = {}
for arch, shape, patch in json.loads(sys.argv[1]):
    mesh_mod.make_production_mesh = auto_axes if patch else shipped
    out[f"{arch} {shape}"] = dryrun.run_cell(arch, shape, False, "")
print(json.dumps(out))
"""


def reference_results(cells=CELLS, timeout=900) -> dict:
    """The JAX dry-run's result of each cell, keyed "arch shape"."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(cells)], env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode:
        raise RuntimeError(f"the JAX dry-run failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def port_results(cells=CELLS) -> dict:
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.dryrun import run_cell
    return {f"{a} {s}": run_cell(a, s, False, "") for a, s, _ in cells}


def main() -> int:
    ref, port = reference_results(), port_results()
    print("| cell | quantity | port | JAX package | port / JAX |")
    print("|---|---|---|---|---|")
    for key in port:
        p, r = port[key], ref[key]
        rows = [("flops/dev", p["cost"]["flops_per_dev"],
                 r["cost"]["flops_per_dev"]),
                ("HBM bytes/dev", p["cost"]["hbm_bytes_per_dev"],
                 r["cost"]["hbm_bytes_per_dev"]),
                ("collective bytes/dev", p["collective_bytes_per_dev"],
                 r["collective_bytes_per_dev"]),
                ("argument bytes/dev", p["memory"]["argument_bytes"],
                 r["memory"]["argument_bytes"])]
        a, b = rows[-1][1:]
        print(f"| {key} | argument bytes/dev, exact | {a} | {b} | "
              f"{(a - b) / b:+.3g} |")
        for name, a, b in rows:
            ratio = f"{a / b:.6g}" if b else "—"
            print(f"| {key} | {name} | {a:.6g} | {b:.6g} | {ratio} |")
        print(f"| {key} | dominant term | {p['roofline']['dominant']} | "
              f"{r['roofline']['dominant']} | |")
        print(f"| {key} | collectives | {json.dumps(p['collectives'])} | "
              f"{json.dumps(r['collectives'])} | |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
