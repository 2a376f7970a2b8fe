"""Helpers of the benchmark's CPU tests: the program at its SMOKE sizes,
with the configuration files cut to match."""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE = {
    "olmo-1b": {"n_layers": 2, "d_model": 64, "n_heads": 4, "kv_heads": 4,
                "head_dim": 16, "d_ff": 128, "vocab": 256},
    "mamba2-370m": {"n_layers": 2, "d_model": 64, "d_state": 16,
                    "headdim": 16, "chunk_size": 16, "vocab": 256},
}


def read_json(rel):
    with open(ROOT / rel) as f:
        return json.load(f)


def smoke_config(name, **over):
    return {**read_json(f"gpubench/configs/{name}.json"), **SMOKE[name],
            **over}


def smoke_traffic(name):
    tr = read_json(f"gpubench/traffic/{name}.json")
    if tr["entry"] == "train":
        tr.update(batch=2, seq=32, pool=4, mesh={"model": 1})
        tr["program"] = {"remat": "none"}
    else:
        tr.update(seq=32, rate=50.0, checked_requests=6, trace_seconds=0.3,
                  warmup_calls=1)
    return tr


def smoke_port_fixture(monkeypatch):
    """The port's configs at their SMOKE sizes (and, given a dtype, with
    that compute dtype)."""
    import dataclasses

    from repro_torch.configs import get_config

    from gpubench import port

    def use(**fields):
        def get(arch):
            return dataclasses.replace(get_config(arch, smoke=True),
                                       **fields)
        monkeypatch.setattr(port, "get_config", get)
    use()
    return use


def context(config, traffic, limits, seed=11, seconds=0.3, trace=False,
            rank=0, world=1):
    import torch

    from gpubench import cells
    return cells.Context(seed, seconds, trace, config, traffic, limits,
                         time.time(), torch.device("cpu"), rank, world)


def cpu_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def dist_worker(rank, world, store_path, limits, fault, queue):
    """One of ``world`` CPU processes (gloo) running the 4-card training
    cell at SMOKE size; with ``fault`` "exchange", the gradients' exchange
    between processes left out (each keeps its own block of its own
    gradient).  Puts (rank, correct, checks) on ``queue``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config

    from gpubench import cells, port

    port.get_config = lambda arch: get_config(arch, smoke=True)
    if fault == "exchange":
        def local_block(g, dim, group):
            n, r = dist.get_world_size(group), dist.get_rank(group)
            return g.chunk(n, dim)[r].contiguous()
        port.runtime._reduce_scatter = local_block
    port.runtime.init_group("cpu", dist.FileStore(store_path, world), rank,
                            world, timeout=timedelta(seconds=120))
    try:
        tr = smoke_traffic("train_fsdp4_32x4096")
        tr["batch"] = world
        ctx = context(smoke_config("olmo-1b"), tr, limits,
                      seed=2 ** 31 + 99, rank=rank, world=world)
        ctx.host_group = dist.new_group(backend="gloo")
        result = cells.run(ctx)
        queue.put((rank, result["correct"], result["checks"]))
    finally:
        dist.destroy_process_group()
    torch.set_num_threads(1)
