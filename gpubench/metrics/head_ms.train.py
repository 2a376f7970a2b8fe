"""Device time of the head in all passes: the final norm and unembedding
product (``unembed``) and the cross-entropy (``loss``), with their
``.bwd`` ranges (``gpubench/parts.py``), per step, in ms."""

from gpubench.parts import ms_per_step


def read(run):
    return ms_per_step(run, parts=("unembed", "loss"))
