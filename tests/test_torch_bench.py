"""The port's copy of the engine's benchmark harness, workload generators
and observability sinks against the JAX package's: the same op streams,
phase results, space amplification, ``stats()``, metrics JSON, traces,
report text and lint verdicts, and the quickstart example's lines.  All
of it runs on the simulated clock, so every comparison is exact."""

import ast
import dataclasses
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro import bench as jbench
from repro.core.options import preset as j_preset
from repro.obs import report as jreport
from repro.obs import runtime as jruntime
from repro_torch import bench
from repro_torch.core import compaction
from repro_torch.obs import report, runtime
from repro_torch.obs.lint import lint_file

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
VALUE_KINDS = ("fixed-4096", "mixed-8k", "pareto-1k", "pareto-8k")
STREAMS = ("load", "update", "read", "scan", "ycsb-a", "ycsb-b", "ycsb-c",
           "ycsb-d", "ycsb-e", "ycsb-f", "multi-client")


def _preset_names() -> list:
    """The keys of the ``presets`` table in the JAX package's ``preset``,
    read from its source so that a system added there is tested here."""
    tree = ast.parse((SRC / "repro" / "core" / "options.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "preset")
    table = next(n.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "presets")
    return [k.value for k in table.keys]


SYSTEMS = _preset_names()


@pytest.fixture(autouse=True)
def _clean_runtimes():
    """``attach`` keeps every store it sees until ``take_sim_time``;
    leave both packages' sink modules empty around each test."""
    for rt in (jruntime, runtime):
        rt.take_sim_time()
        rt.configure()
    yield
    for rt in (jruntime, runtime):
        rt.take_sim_time()
        rt.configure()


def _stream(pkg, kind: str, which: str) -> list:
    spec = pkg.WorkloadSpec(value_kind=kind, dataset_bytes=256 << 10,
                            update_bytes=1 << 20, scan_max=20)
    if which == "load":
        return list(pkg.gen_load(spec))
    if which == "update":
        return list(pkg.gen_update(spec))
    if which == "read":
        return list(pkg.gen_read(spec, 300))
    if which == "scan":
        return list(pkg.gen_scan(spec, 300))
    if which.startswith("ycsb-"):
        return list(pkg.gen_ycsb(spec, which[len("ycsb-"):], 300))
    return list(pkg.gen_multi_client(spec, 3, "ycsb-a", 100))


@pytest.mark.parametrize("which", STREAMS)
@pytest.mark.parametrize("kind", VALUE_KINDS)
def test_op_streams_equal_the_jax_packages(kind, which):
    got, want = _stream(bench, kind, which), _stream(jbench, kind, which)
    assert len(want) >= 64
    assert got == want


def _phases(pkg, system: str, sharded: bool) -> dict:
    spec = pkg.WorkloadSpec(value_kind="mixed-8k", dataset_bytes=1 << 20,
                            update_bytes=2 << 20)
    kw = dict(n_shards=2, space_limit_x=3.0) if sharded else {}
    batch = 8 if sharded else 0
    db = pkg.make_db(system, spec, **kw)
    load = pkg.run_phase(db, "load", pkg.gen_load(spec), drain=True,
                         batch=batch)
    upd = pkg.run_phase(db, "update", pkg.gen_update(spec), drain=True,
                        capture_latency=True, batch=batch)
    results = [{k: v for k, v in dataclasses.asdict(r).items()
                if k != "wall_seconds"} for r in (load, upd)]
    return {"phases": results,
            "space_amplification": pkg.space_amplification(db),
            "stats": db.stats(),
            "oracle": (db.oracle.logical_bytes, db.oracle.sep_bytes)}


@pytest.mark.parametrize("system, sharded",
                         [(s, False) for s in SYSTEMS]
                         + [("scavenger_plus", True)])
def test_phases_equal_the_jax_packages(system, sharded, monkeypatch):
    """A load, then an update with latency capture, on a 1 MB dataset:
    every ``PhaseResult`` field but ``wall_seconds`` (a host time), the
    space amplification, ``stats()`` and the oracle's byte counts.  Every
    separating system reclaims garbage in the run."""
    rewritten = []

    class CountingWriter(compaction.LogTableWriter):
        def add(self, key, value):
            rewritten.append(len(value))
            return super().add(key, value)

    # Compaction opens a LogTableWriter only to rewrite blobs.
    monkeypatch.setattr(compaction, "LogTableWriter", CountingWriter)
    got = _phases(bench, system, sharded)
    want = _phases(jbench, system, sharded)
    assert got == want
    upd = got["phases"][1]
    assert upd["ops"] > 0 and upd["p99_us"] > 0
    opts = j_preset(system)
    if opts.kv_separation and opts.gc_mode == "standalone":
        assert got["stats"]["counters"]["gc_runs"] >= 1
    elif opts.kv_separation:
        # BlobDB's GC rewrites blobs inside compactions and counts no
        # gc_run.
        assert len(rewritten) >= 1


def _sink_run(pkg, rt, out: Path) -> tuple:
    """Two stores through the harness with both sinks configured, as
    ``benchmarks/run.py --trace= --metrics-json=`` runs them."""
    out.mkdir()
    trace, metrics = out / "trace.json", out / "metrics.json"
    rt.configure(trace=str(trace), metrics=str(metrics))
    spec = pkg.WorkloadSpec(value_kind="fixed-4096", dataset_bytes=512 << 10,
                            update_bytes=1 << 20)
    for system in ("terarkdb", "scavenger_plus"):
        db = pkg.make_db(system, spec)
        pkg.run_phase(db, "load", pkg.gen_load(spec), drain=True)
        pkg.run_phase(db, "update", pkg.gen_update(spec), drain=True,
                      capture_latency=True)
    written = rt.flush()
    return written, rt.take_sim_time(), trace, metrics


def test_sinks_write_what_the_jax_packages_write(tmp_path):
    """The traces compare event for event: every timestamp is on the
    simulated clock and every pid and tid is a counter, so no field is
    left out."""
    w_got, t_got, trace, metrics = _sink_run(bench, runtime, tmp_path / "t")
    w_want, t_want, j_trace, j_metrics = _sink_run(jbench, jruntime,
                                                   tmp_path / "j")
    assert [Path(p).name for p in w_got] == [Path(p).name for p in w_want] \
        == ["metrics.json", "trace.json"]
    assert t_got == t_want > 0
    got, want = json.loads(metrics.read_text()), \
        json.loads(j_metrics.read_text())
    assert list(got) == ["terarkdb#0", "scavenger_plus#1"]
    assert got == want
    events = json.loads(trace.read_text())["traceEvents"]
    assert events == json.loads(j_trace.read_text())["traceEvents"]
    assert len(events) > 100
    assert lint_file(str(trace)) == []


@pytest.fixture(scope="module")
def metrics_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("report")
    _, _, trace, metrics = _sink_run(bench, runtime, out / "run")
    runtime.configure()
    return metrics, trace


def test_report_renders_what_the_jax_package_renders(metrics_file):
    doc = json.loads(metrics_file[0].read_text())
    for snap in doc.values():
        got, want = io.StringIO(), io.StringIO()
        report.render(snap, out=got)
        jreport.render(snap, out=want)
        assert got.getvalue() == want.getvalue()
        assert "p99 attribution" in got.getvalue()


def _cli(module: str, *args) -> tuple:
    res = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, env=ENV, timeout=120)
    return res.returncode, res.stdout, res.stderr


@pytest.mark.parametrize("single", [False, True])
def test_report_cli_prints_what_the_jax_cli_prints(metrics_file, tmp_path,
                                                   single):
    """On the harness's ``{label: snapshot}`` dump and on one snapshot."""
    path = metrics_file[0]
    if single:
        path = tmp_path / "one.json"
        doc = json.loads(metrics_file[0].read_text())
        path.write_text(json.dumps(doc["scavenger_plus#1"]))
    got = _cli("repro_torch.obs.report", str(path))
    assert got == _cli("repro.obs.report", str(path))
    assert got[0] == 0 and "p50 / p95 / p99" in got[1]


def _broken_trace(path: Path) -> None:
    """A B span that no E closes, an E that no B opened, and a flow
    origin with no terminus."""
    events = [
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "lane0"}},
        {"ph": "B", "name": "flush", "pid": 1, "tid": 1, "ts": 1.0},
        {"ph": "E", "name": "flush", "pid": 1, "tid": 1, "ts": 2.0},
        {"ph": "E", "name": "gc", "pid": 1, "tid": 1, "ts": 3.0},
        {"ph": "B", "name": "compaction", "pid": 1, "tid": 1, "ts": 4.0},
        {"ph": "s", "name": "commit", "cat": "flow", "id": 7, "pid": 1,
         "tid": 1, "ts": 5.0},
    ]
    path.write_text(json.dumps({"traceEvents": events}))


@pytest.mark.parametrize("case", ["valid", "broken", "unreadable",
                                  "no-argument"])
def test_lint_cli_gives_the_jax_clis_verdict(metrics_file, tmp_path, case):
    args = []
    if case == "valid":
        args = [str(metrics_file[1])]
    elif case == "broken":
        args = [str(tmp_path / "broken.json")]
        _broken_trace(Path(args[0]))
    elif case == "unreadable":
        args = [str(tmp_path / "cut.json")]
        Path(args[0]).write_text('{"traceEvents": [')
    got = _cli("repro_torch.obs.lint", *args)
    assert got == _cli("repro.obs.lint", *args)
    assert got[0] == {"valid": 0, "broken": 1, "unreadable": 1,
                      "no-argument": 2}[case]
    if case == "broken":
        assert "without B" in got[2] and "flow" in got[2]
        assert len(lint_file(args[0])) >= 3


def test_torch_quickstart_prints_the_jax_example_lines():
    """The last line, ``concurrent: 4 threads, N records in M wal_syncs``,
    counts the WAL syncs of four client threads whose commit groups
    coalesce as the host schedules them, so M differs from run to run of
    the same script; only its form is compared.  Every other line is
    compared exactly."""
    procs = [subprocess.Popen([sys.executable, str(ROOT / "examples" / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=ENV)
             for s in ("torch_quickstart.py", "quickstart.py")]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out.splitlines())
    got, want = outs
    assert got[:-1] == want[:-1]
    assert len(got) == len(want) == 11
    form = re.compile(r"concurrent: 4 threads, 256 records in \d+ wal_syncs "
                      r"\(\d+\.\d records/sync\)")
    assert form.fullmatch(got[-1]) and form.fullmatch(want[-1])
