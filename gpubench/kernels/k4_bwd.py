"""K4-bwd: the SSD scan's backward (``csrc/ssd_scan_bwd.cu``)."""

from gpubench.reference import cost

from .k4 import shapes

COUNTER = "ssd_scan.bwd_launches"


def matches(name: str) -> bool:
    return "ssd_bwd_" in name


def work(run):
    return (*cost.ssd_bwd(*shapes(run)), "float32")
