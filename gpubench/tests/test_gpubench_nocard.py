"""A run that finds no card fails: it exits non-zero and prints no result,
and never runs on the CPU."""

import json
import shutil
import subprocess
import sys

import pytest

from gpubench_helpers import ROOT, cpu_env


def _run(cwd, workload):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 12345), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=cpu_env(), capture_output=True, text=True, timeout=120)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.parametrize("workload", ["olmo-1b.train", "olmo-1b.prefill",
                                      "olmo-1b.train_fsdp4"])
def test_no_card_exits_non_zero_without_a_result(workload):
    out = _run(ROOT, workload)
    assert out.returncode != 0
    assert "CUDA card" in out.stderr
    _no_result(out)


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, "olmo-1b.train")
    assert out.returncode != 0
    _no_result(out)
