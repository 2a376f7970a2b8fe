"""K4: the SSD scan (``csrc/ssd_scan.cu``; its three launches)."""

from gpubench.reference import cost

COUNTER = "ssd_scan.launches"


def matches(name: str) -> bool:
    return "ssd_scan_" in name


def shapes(run):
    """(rows, seq, heads, head width, state) of one call."""
    c = run.config
    di = c["expand"] * c["d_model"]
    return (run.traffic["batch"] // run.world, run.traffic["seq"],
            di // c["headdim"], c["headdim"], c["d_state"])


def work(run):
    return (*cost.ssd_fwd(*shapes(run)), "float32")
