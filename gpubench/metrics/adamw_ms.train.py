"""Device time of the optimizer: the operations launched inside the
program's ``adamw`` range (``train/step.py``), per step, in ms."""

from gpubench.readers import range_ms


def read(run):
    return range_ms(run, "adamw")
