"""A call's model flops (``reference/cost.py``) over its median span and the
card's bf16 peak, in %."""

from gpubench.readers import mfu_calls


def read(run):
    return mfu_calls(run)
