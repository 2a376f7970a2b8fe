"""No module that the benchmark or a run of a cell loads is JAX or the JAX
package (``repro``), by its whole top-level name; the reference loads
nothing of the program; nothing reads the JAX package's benchmark
folder."""

import subprocess
import sys

import pytest

from gpubench_helpers import ROOT, cpu_env

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

CELL_RUN = """
import sys, json, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch
from gpubench import cells, port
from gpubench_helpers import smoke_config, smoke_traffic
from repro_torch.configs import get_config
port.get_config = lambda arch: get_config(arch, smoke=True)
for cfg, tr in (("olmo-1b", "train_8x4096"), ("mamba2-370m", "train_8x4096"),
                ("olmo-1b", "prefill_2x4096")):
    limits = {{"loss": {{"limit": 1}}, "grad": {{"limit": 1}},
              "change": {{"limit": 1}}, "token_gap": {{"limit": 1}}}}
    ctx = cells.Context(3, 0.2, False, smoke_config(cfg), smoke_traffic(tr),
                        limits, time.time(), torch.device("cpu"))
    cells.run(ctx)
import gpubench.run, gpubench.calibrate, gpubench.readers
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=cpu_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cell_run_loads_no_jax_and_no_jax_package():
    found = _modules(CELL_RUN.format(root=str(ROOT), src=str(ROOT / "src"),
                                     tests=str(ROOT / "gpubench" / "tests")))
    assert "repro_torch" in found and "gpubench" in found
    assert not found & FORBIDDEN


@pytest.mark.parametrize("module", ["gpubench.reference.models",
                                    "gpubench.reference.train",
                                    "gpubench.reference.cost",
                                    "gpubench.reference.families.dense",
                                    "gpubench.reference.families.ssm",
                                    "gpubench.weights", "gpubench.checks"])
def test_the_reference_loads_nothing_of_the_program(module):
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            f"import {module}; "
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    found = _modules(code)
    assert "repro_torch" not in found and not found & FORBIDDEN


def test_no_source_reads_the_jax_package_or_its_benchmarks():
    for path in (ROOT / "gpubench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "import repro\n" not in text and "from repro." not in text
        assert "import jax" not in text and "from jax" not in text
        assert '"benchmarks' not in text and "'benchmarks" not in text
