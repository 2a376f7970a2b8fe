"""The program under test, ``repro_torch``, as the benchmark drives it: its
configurations, step builders, optimizer state, mesh and counters.  The
only module of the benchmark that imports it, but for ``run.py``'s build of
its kernels.

A configuration file names the port's arch and the fields it replaces;
``model_config`` builds the port's config from them and refuses to run
where a size the file states differs from the port's.
"""

from __future__ import annotations

import dataclasses
import sys

from .manifest import ROOT

sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel import runtime  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         init_state)
from repro_torch.train.step import (TrainConfig,  # noqa: E402
                                    build_prefill_step, build_train_step,
                                    step_specs)

# the configuration file's key -> the port's field
FIELDS = {"n_layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
          "kv_heads": "kv_heads", "head_dim": "head_dim", "d_ff": "d_ff",
          "vocab": "vocab", "ffn_act": "ffn_act", "rope_theta": "rope_theta",
          "d_state": "ssm_state", "headdim": "ssm_headdim",
          "expand": "ssm_expand", "chunk_size": "ssm_chunk"}
KERNELS = "repro_torch.kernels."
NORMS = {"layernorm_nonparametric": "nonparametric", "rmsnorm": "rms"}

__all__ = ["make_host_mesh", "runtime", "step_specs", "init_state"]


def model_config(config: dict, traffic: dict):
    """The port's config for this file and mix: its arch with the fields
    the file's and the mix's ``program`` entries replace, checked against
    every size the file states."""
    cfg = dataclasses.replace(get_config(config["arch"]),
                              **config.get("program", {}),
                              **traffic.get("program", {}))
    wrong = [f"{k}: file {config[k]!r}, port {getattr(cfg, f)!r}"
             for k, f in FIELDS.items()
             if k in config and getattr(cfg, f) != config[k]]
    if cfg.family != config["family"]:
        wrong.append(f"family: {config['family']} / {cfg.family}")
    if NORMS[config["norm"]] != cfg.ln_kind:
        wrong.append(f"norm: {config['norm']} / {cfg.ln_kind}")
    for k in ("param_dtype", "compute_dtype"):
        if str(getattr(cfg, k)) != f"torch.{config[k]}":
            wrong.append(f"{k}: {config[k]} / {getattr(cfg, k)}")
    if wrong:
        raise ValueError(f"{config['arch']}: the configuration file and the "
                         "port disagree: " + "; ".join(wrong))
    return cfg


def train_config(traffic: dict):
    return TrainConfig(microbatches=traffic.get("microbatches", 1),
                       adamw=AdamWConfig(**traffic["adamw"]))


def train_step(cfg, traffic: dict, device, mesh=None):
    step, (params_abs, _, _) = build_train_step(
        cfg, traffic["batch"], traffic["seq"], train_config(traffic), device,
        mesh=mesh)
    return step, params_abs


def prefill_step(cfg, traffic: dict, device):
    step, (params_abs, _) = build_prefill_step(cfg, traffic["batch"],
                                               traffic["seq"], device)
    return step, params_abs


def check_tree(params: dict, abstract: dict, path: str = "") -> None:
    """Raise unless ``params`` has the keys, shapes and dtypes of the
    program's abstract params."""
    if set(params) != set(abstract):
        raise ValueError(f"param tree {path or '/'}: {sorted(params)} "
                         f"against the program's {sorted(abstract)}")
    for k, v in abstract.items():
        if isinstance(v, dict):
            check_tree(params[k], v, f"{path}{k}.")
        elif params[k].shape != v.shape or params[k].dtype != v.dtype:
            raise ValueError(f"{path}{k}: {tuple(params[k].shape)} "
                             f"{params[k].dtype} against the program's "
                             f"{tuple(v.shape)} {v.dtype}")


def kernel_calls() -> dict:
    """The program's own counts of kernel calls since it started: every
    counter (an int whose name ends in ``launches``) of every loaded module
    of ``repro_torch.kernels``, as ``<module>.<counter>``."""
    out = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith(KERNELS) or module is None:
            continue
        for attr, value in vars(module).items():
            if attr.endswith("launches") and type(value) is int:
                out[f"{name[len(KERNELS):]}.{attr}"] = value
    return out
