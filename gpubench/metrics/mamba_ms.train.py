"""Device time of the Mamba-2 (SSD) layers in all three passes: the
operations in the program's ``mamba``, ``mamba.remat`` and ``mamba.bwd``
ranges (``gpubench/parts.py``), per step, in ms."""

from gpubench.parts import ms_per_step


def read(run):
    return ms_per_step(run, parts=("mamba",))
