"""Device time of the NCCL kernels per step, in ms (waits inside them
included)."""

from gpubench.readers import nccl


def read(run):
    seconds, launches = nccl(run)
    return 1e3 * seconds / run.steps if launches else None
