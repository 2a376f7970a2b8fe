"""A configuration, a model family, a traffic mix, an entry, a cell's
limits, a kernel and a per-layer metric dropped in as new files are found
by name: adding them edits no file that is there, only adds entries to
BENCHMARK.json."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

from gpubench_helpers import ROOT, cpu_env

from gpubench import manifest


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    folder = root / "gpubench"
    shutil.copytree(ROOT / "gpubench", folder,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(folder)

    config = json.loads((folder / "configs" / "olmo-1b.json").read_text())
    config.update(name="olmo-1b-wide", d_ff=16384)
    (folder / "configs" / "olmo-1b-wide.json").write_text(json.dumps(config))
    traffic = {"entry": "prefill", "batch": 4, "seq": 2048, "rate": 6.0,
               "spread": 0.25, "warmup_calls": 2, "checked_requests": 8,
               "trace_seconds": 2.0}
    (folder / "traffic" / "prefill_4x2048.json").write_text(
        json.dumps(traffic))
    (folder / "limits" / "olmo-1b-wide.prefill.json").write_text(
        json.dumps({"token_gap": {"limit": 0.5}}))
    (folder / "metrics" / "calls.prefill.py").write_text(
        "def read(run):\n    return float(run.steps)\n")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "olmo-1b-wide", "source": "x",
                             "file": "gpubench/configs/olmo-1b-wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "olmo-1b-wide.prefill",
                               "config": "olmo-1b-wide",
                               "traffic": "prefill_4x2048", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "ttft_p95_ms":
            m["workloads"].append("olmo-1b-wide.prefill")
    bench["per_layer"].append({"name": "calls.prefill", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "device (H100)",
                               "moves": "ttft_p95_ms",
                               "workloads": ["olmo-1b-wide.prefill"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    man = manifest.Manifest(root, folder)
    cell = man.cell("olmo-1b-wide.prefill")
    assert man.config(cell["config"])["d_ff"] == 16384
    assert man.traffic(cell["traffic"]) == traffic
    assert man.limits(cell["name"]) == {"token_gap": {"limit": 0.5}}
    assert [m["name"] for m in man.end_to_end(cell["name"])] == [
        "ttft_p95_ms", "peak_mem_gib", "setup_s"]
    assert "calls.prefill" in [m["name"] for m in man.per_layer(cell["name"])]

    class Run:
        steps = 7
    assert man.reader("calls.prefill")(Run()) == 7.0
    # the new cell's entry is one that is there
    from gpubench import cells
    assert cells.entry(traffic["entry"]).run

    after = _digests(folder)
    assert {k: v for k, v in after.items() if k in before} == before


# A family of its own: one gated FFN a layer and an RMSNorm, no mixing
# between positions.
FAMILY = """
from gpubench.reference.models import rmsnorm, run_layers
from gpubench.reference.families import stacked


def leaves(cfg):
    d, f = cfg["d_model"], cfg["d_ff"]
    return stacked(cfg, [("final_norm", (d,), "ones", 0.0)], [
        ("norm", (d,), "ones", 0.0),
        ("wi", (d, f), "normal", d ** -0.5),
        ("wo", (f, d), "normal", f ** -0.5)])


def layer(x, lw, positions, cfg, prec):
    h = rmsnorm(x, lw["norm"], cfg["norm_eps"])
    return x + prec.einsum("bsf,fd->bsd",
                           prec.einsum("bsd,df->bsf", h, lw["wi"]).relu(),
                           lw["wo"])


def hidden(w, tokens, cfg, prec):
    x = run_layers(w, tokens, cfg, prec, layer)
    return rmsnorm(x, w["final_norm"], cfg["norm_eps"])


def matrix_params(cfg):
    d = cfg["d_model"]
    return cfg["n_layers"] * 2 * d * cfg["d_ff"] + d * cfg["vocab"]


def mixer_flops(cfg, batch, seq, train):
    return 0
"""

# An entry of its own: the reference's last logits of seeded prompts,
# judged against themselves, and the cell's model flops.
ENTRY = """
import time

from gpubench import checks, weights
from gpubench.reference import cost, models


def run(ctx):
    tr, cfg = ctx.traffic, ctx.config
    w = {n: x.float() for n, x in
         weights.flatten(weights.make_params(cfg, ctx.seed, ctx.device))
         .items()}
    tokens = weights.token_batches(ctx.seed, 1, 1, tr["batch"], tr["seq"],
                                   cfg["vocab"], ctx.device)[0]
    logits = models.last_logits(w, tokens, cfg)
    gaps = checks.served_gaps(logits, logits.argmax(-1))
    numbers = {"token_gap": {"value": max(gaps), "where": "all"}}
    correct, got = checks.verdict(numbers, ctx.limits)
    return {"setup_s": time.time() - ctx.t_start, "correct": correct,
            "checks": got, "numbers": numbers, "attempted": 1, "failed": 0,
            "flops": cost.model_flops(cfg, tr["batch"], tr["seq"], False),
            "leaves": len(weights.leaf_specs(cfg))}


def controls(ctx):
    return {}
"""

KERNEL = """
COUNTER = "toy.launches"


def matches(name):
    return name.startswith("toy_")


def work(run):
    return 989e9, 0, "bfloat16"
"""

RUN_CELL = """
import json, sys, time
sys.path.insert(0, ".")
import torch
from gpubench import cells, readers
from gpubench.manifest import Manifest

man = Manifest()
cell = man.cell("toy.echo")
ctx = cells.Context(5, 0.1, False, man.config(cell["config"]),
                    man.traffic(cell["traffic"]), man.limits(cell["name"]),
                    time.time(), torch.device("cpu"))
r = cells.run(ctx)


class Trace:
    def device_time(self, match):
        return (0.002, 2) if match("toy_kernel") else (0.0, 0)


class Run:
    trace, calls = Trace(), {"toy.launches": 1}


print(json.dumps({"correct": r["correct"], "flops": r["flops"],
                  "leaves": r["leaves"],
                  "roofline": man.reader("k9_roofline.echo")(Run())}))
"""


def test_a_new_family_entry_and_kernel_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    folder = root / "gpubench"
    shutil.copytree(ROOT / "gpubench", folder,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(folder)

    (folder / "reference" / "families" / "toy.py").write_text(FAMILY)
    (folder / "entries" / "echo.py").write_text(ENTRY)
    (folder / "kernels" / "k9.py").write_text(KERNEL)
    (folder / "metrics" / "k9_roofline.echo.py").write_text(
        "from gpubench.readers import roofline\n\n\n"
        "def read(run):\n    return roofline(run, 'k9')\n")
    config = {"name": "toy", "family": "toy", "n_layers": 2, "d_model": 16,
              "d_ff": 32, "vocab": 64, "norm_eps": 1e-6,
              "param_dtype": "float32", "source": "x", "reduced": []}
    (folder / "configs" / "toy.json").write_text(json.dumps(config))
    (folder / "traffic" / "echo_2x8.json").write_text(
        json.dumps({"entry": "echo", "batch": 2, "seq": 8}))
    (folder / "limits" / "toy.echo.json").write_text(
        json.dumps({"token_gap": {"limit": 0.0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "x",
                             "file": "gpubench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.echo", "config": "toy",
                               "traffic": "echo_2x8", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "k9_roofline.echo", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "setup_s",
                               "workloads": ["toy.echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    # the program from this checkout's src (the copy holds the benchmark)
    env = dict(cpu_env(), PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN_CELL)],
                         cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    d, f, v = 16, 32, 64
    assert got["correct"] is True
    assert got["leaves"] == 3 + 3
    assert got["flops"] == 2 * (2 * 2 * d * f + d * v) * 2 * 8
    # 1 call of 1 ms at the bf16 peak over 2 ms of launches
    assert abs(got["roofline"] - 50.0) < 1e-9

    after = _digests(folder)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_declared_metric_has_a_reader():
    man = manifest.Manifest()
    for w in man.data["workloads"]:
        for m in man.per_layer(w["name"]):
            assert callable(man.reader(m["name"]))
