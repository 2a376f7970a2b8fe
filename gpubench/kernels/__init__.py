"""The program's kernels that the benchmark reads a roofline share of, one
module a kernel, found by name as ``kernels/<kernel>.py``.  A later change
adds a kernel by adding its module, and edits no file that is there.

Each module gives:

* ``COUNTER``: the program's count of the kernel's calls, as
  ``gpubench.port.kernel_calls`` names it (``<module>.<counter>``);
* ``matches(name)``: whether a device operation of the trace, by its name,
  is one of the kernel's launches;
* ``work(run)``: (flops, bytes, dtype of its products) of one call at the
  cell's shapes, from the frozen formulas of ``reference/cost.py``.
"""

import importlib


def kernel(name: str):
    return importlib.import_module(f"{__name__}.{name}")
