"""Device time of attention in all three passes: the operations in the
program's ``attention``, ``attention.remat`` and ``attention.bwd`` ranges
(``gpubench/parts.py``), per step, in ms."""

from gpubench.parts import ms_per_step


def read(run):
    return ms_per_step(run, parts=("attention",))
