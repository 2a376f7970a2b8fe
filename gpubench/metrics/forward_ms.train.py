"""Device time of the forward pass: the operations in every program range
without a pass suffix (``gpubench/parts.py``), but the gradient norm's and
AdamW's, per step, in ms."""

from gpubench.parts import ms_per_step


def read(run):
    return ms_per_step(run, passes=("forward",),
                       without=("adamw", "grad_norm"))
