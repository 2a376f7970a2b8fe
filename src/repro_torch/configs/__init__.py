"""Architecture configs (full CONFIG and reduced SMOKE variants).

Every module exports CONFIG (full width) and SMOKE (tiny, for CPU tests).
``get_config(name, smoke=False)`` resolves by arch id.  Only the archs whose
models run in this package have a module here; the others raise.
"""

from __future__ import annotations

import importlib

ARCHS = ["phi3_medium_14b", "phi3_mini_3_8b", "starcoder2_3b", "olmo_1b",
         "mamba2_370m"]


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    raise KeyError(f"unknown or not yet ported arch {name!r}; known: {ARCHS}")


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
