"""Device time of attention: the operations launched inside the program's
``attention`` ranges (``models/transformer.py``), per call, in ms."""

from gpubench.readers import range_ms


def read(run):
    return range_ms(run, "attention")
