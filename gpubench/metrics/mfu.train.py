"""The steps' model flops (``reference/cost.py``) over the traced window and
the cards' bf16 peak, in %."""

from gpubench.readers import mfu_train


def read(run):
    return mfu_train(run)
