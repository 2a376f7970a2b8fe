"""% of the traced window in which no device operation ran."""

from gpubench.readers import idle_share_window


def read(run):
    return idle_share_window(run)
