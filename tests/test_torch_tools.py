"""tools/smoke_timeline.py: each run's wall time split into the time before
its first line, the ``[checkpoint]`` phase, the repeat checks and the rest.
Runs a stand-in ``chip_smoke.py`` that prints those lines, on the CPU."""

import importlib.util
from pathlib import Path


def _timeline():
    path = Path(__file__).resolve().parents[1] / "tools" / "smoke_timeline.py"
    spec = importlib.util.spec_from_file_location("smoke_timeline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TIMELINE = _timeline()

STAND_IN = """import sys, time
time.sleep(0.2)
print("[build] 6 libraries built in 0.2s into build/kernels")
print("[train olmo-1b] one step twice: bit-identical: True; check wall 0.100 s")
print("[train mamba2-370m] one step twice: bit-identical: True; check wall 0.050 s")
print("[checkpoint] phase wall 0.300 s")
sys.exit({rc})
"""


def test_timeline_splits_each_run(tmp_path, capsys):
    runs = []
    for name, rc in (("parent", 0), ("change", 3)):
        d = tmp_path / name
        d.mkdir()
        (d / "chip_smoke.py").write_text(STAND_IN.format(rc=rc))
        runs.append(str(d))
    out = tmp_path / "out"
    assert TIMELINE.main(runs + ["--out", str(out)]) == 3
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == \
        [f"[timeline] run 0 {runs[0]}", f"[timeline] run 1 {runs[1]}"]
    assert "rc 0," in lines[0] and "rc 3," in lines[1]
    assert "build 0.200 s, checkpoint 0.300 s, repeat_checks 0.150 s" \
        in lines[0]
    logs = sorted(p.name for p in out.iterdir())
    assert logs == ["timeline_0_parent.log", "timeline_1_change.log"]
    stamped = (out / logs[0]).read_text().splitlines()
    assert len(stamped) == 4 and stamped[0].split(None, 1)[1].startswith(
        "[build]")


def test_summarize_parts_add_up_to_the_wall():
    stamped = [(12.0, "[build] 6 libraries built in 9.5s into x"),
               (20.0, "[train a] ...; check wall 1.000 s"),
               (30.0, "[checkpoint] phase wall 6.000 s")]
    parts = TIMELINE.summarize(stamped, 2.0, 32.0)
    assert parts == {"wall": 30.0, "before_first_line": 10.0, "build": 9.5,
                     "checkpoint": 6.0, "repeat_checks": 1.0, "rest": 13.0}
