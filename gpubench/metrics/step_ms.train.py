"""The median training step: from its first device operation to its last
(device trace), in ms."""

from gpubench.readers import median_step_ms


def read(run):
    return median_step_ms(run)
