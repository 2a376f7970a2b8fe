"""What a run reads by name: ``BENCHMARK.json`` at the root of the checkout,
and the files of the benchmark's folder that it names.

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``traffic/<traffic>.json``, parameters that the entry
  it names reads (``gpubench/entries/<entry>.py``, ``gpubench.cells``);
* a cell's limits for ``correct``: ``limits/<cell>.json``;
* a per-layer metric: ``metrics/<metric>.py``, a reader with a
  ``read(run)`` function.

A configuration's family is found by name in the same way
(``reference/families/<family>.py``), and so is a kernel that a roofline
metric reads (``kernels/<kernel>.py``).  So a later change adds a
configuration, a family, a mix, an entry, a cell, a kernel or a metric by
adding files and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT, folder: Path = HERE):
        self.root = Path(root)
        self.folder = Path(folder)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.folder / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, cell: str) -> dict:
        with open(self.folder / "limits" / f"{cell}.json") as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it
        (every per-layer metric names its cells)."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.folder / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
