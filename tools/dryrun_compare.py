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
changes.  Prints, per cell, each side's flops, transcendentals, HBM
bytes and collective bytes per device and argument bytes, and the port's
over the JAX package's; then each side's collectives by kind, calls and
bytes.  The JAX side's transcendentals and collective calls are read
from the same compiles its dry-run makes (its cost analysis, and its
HLO's collective ops counted as its ``collective_bytes`` sums them) and
corrected for the layer loop as it corrects flops (``corrected_costs``).
The JAX numbers are XLA's cost analysis for the TPU v5e target's compile
on host devices, not a measurement; the port's are counts of one
device's step on meta tensors (``repro_torch.launch.dryrun``).
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

_REFERENCE = r"""
import json, re, sys
import jax
from jax.sharding import AxisType
import repro.launch.mesh as mesh_mod
from repro.configs import get_config
from repro.launch import dryrun

shipped = mesh_mod.make_production_mesh
compile_cell = dryrun._compile_cell
compiles = []


def counting_compile(cfg, *args, **kwargs):
    # each compile's transcendentals and collective calls by kind, beside
    # what the dry-run reads from it
    compiled, cost, coll = compile_cell(cfg, *args, **kwargs)
    calls = {}
    for line in compiled.as_text().splitlines():
        m = re.match(r"^(?:ROOT\s+)?%?[\w.-]+\s*=\s*(.*)$", line.strip())
        cm = dryrun._COLL_RE.search(m.group(1)) if m else None
        if cm:
            kind = cm.group(1).lower()
            calls[kind] = calls.get(kind, 0) + 1
    compiles.append((float(cost.get("transcendentals", 0.0)), calls))
    return compiled, cost, coll


def corrected(cfg, key):
    # the two-point loop correction of corrected_costs, applied to the last
    # two compiles (one unit of layers, then two)
    steps = cfg.n_layers // dryrun._scan_unit(cfg)
    (t1, c1), (t2, c2) = compiles[-2:]
    if key == "transcendentals":
        return t1 + (steps - 1) * max(0.0, t2 - t1)
    return {k: int(c1.get(k, 0) + (steps - 1)
                   * max(0, c2.get(k, 0) - c1.get(k, 0)))
            for k in sorted(set(c1) | set(c2))}


dryrun._compile_cell = counting_compile


def auto_axes(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


out = {}
for arch, shape, patch in json.loads(sys.argv[1]):
    mesh_mod.make_production_mesh = auto_axes if patch else shipped
    r = dryrun.run_cell(arch, shape, False, "")
    cfg = get_config(arch)
    r["cost"]["transcendentals_per_dev"] = corrected(cfg, "transcendentals")
    r["collective_calls"] = corrected(cfg, "calls")
    out[f"{arch} {shape}"] = r
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
                ("transcendentals/dev", p["cost"]["transcendentals_per_dev"],
                 r["cost"]["transcendentals_per_dev"]),
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
        for kind in sorted(set(p["collectives"]) | set(r["collectives"])):
            a = (p["collective_calls"].get(kind, 0),
                 p["collectives"].get(kind, 0))
            b = (r["collective_calls"].get(kind, 0),
                 r["collectives"].get(kind, 0))
            ratio = f"{a[1] / b[1]:.6g}" if b[1] else "—"
            print(f"| {key} | {kind}: calls, bytes | {a[0]}, {a[1]} | "
                  f"{b[0]}, {b[1]} | {ratio} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
