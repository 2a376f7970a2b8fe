"""Device time of the FFN in all three passes: the operations in the
program's ``ffn``, ``ffn.remat`` and ``ffn.bwd`` ranges
(``gpubench/parts.py``), per step, in ms."""

from gpubench.parts import ms_per_step


def read(run):
    return ms_per_step(run, parts=("ffn",))
