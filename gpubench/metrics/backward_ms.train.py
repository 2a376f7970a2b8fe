"""Device time of the backward pass: the operations in every program
range ``<part>.bwd`` (``gpubench/parts.py``), per step, in ms."""

from gpubench.parts import ms_per_step


def read(run):
    return ms_per_step(run, passes=("bwd",))
