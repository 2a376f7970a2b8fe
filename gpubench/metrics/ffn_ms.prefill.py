"""Device time of the FFN: the operations launched inside the program's
``ffn`` ranges (``models/transformer.py``), per call, in ms."""

from gpubench.readers import range_ms


def read(run):
    return range_ms(run, "ffn")
