"""Architecture configs (full CONFIG and reduced SMOKE variants).

Every module exports CONFIG (full width) and SMOKE (tiny, for CPU tests).
``get_config(name, smoke=False)`` resolves by arch id.  The archs are the
JAX package's, every one.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "grok_1_314b", "granite_moe_3b_a800m", "phi3_medium_14b",
    "phi3_mini_3_8b", "starcoder2_3b", "olmo_1b", "hubert_xlarge",
    "mamba2_370m", "jamba_v0_1_52b", "qwen2_vl_2b",
]


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
