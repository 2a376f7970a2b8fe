"""The share of its roofline that k3 reaches in the prefill, in %: its calls'
least time (``kernels/k3.py``) over its launches' device time."""

from gpubench.readers import roofline


def read(run):
    return roofline(run, "k3")
