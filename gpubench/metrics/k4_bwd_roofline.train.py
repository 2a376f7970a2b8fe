"""The share of its roofline that k4_bwd reaches in the training step, in %:
its calls' least time (``kernels/k4_bwd.py``) over its launches' device
time."""

from gpubench.readers import roofline


def read(run):
    return roofline(run, "k4_bwd")
