"""NCCL kernels launched per step: the collectives the runtime issued."""

from gpubench.readers import nccl


def read(run):
    _, launches = nccl(run)
    return launches / run.steps if launches else None
