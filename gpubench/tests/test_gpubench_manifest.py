"""BENCHMARK.json against the rules it is written to, and the files of the
benchmark's folder that it names."""

import re

import pytest

from gpubench_helpers import ROOT, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = read_json("BENCHMARK.json")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    metrics = [e["name"] for g in ("end_to_end", "per_layer")
               for e in BENCH[g]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = read_json(c["file"])
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        read_json(f"gpubench/traffic/{w['traffic']}.json")
        limits = read_json(f"gpubench/limits/{w['name']}.json")
        for name, n in limits.items():
            if name != "not_compared":
                assert n["lower"] < n["limit"] < n["upper"], name
    for m in BENCH["per_layer"]:
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").exists()


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    assert len(four) <= 1


def _e2e_cells(m):
    return set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in _e2e_cells(m)]
        assert any(m["name"] == "setup_s" for m in mine)
        assert any(m["name"] != "setup_s" for m in mine)
        layers = [m for m in BENCH["per_layer"]
                  if w["name"] in m.get("workloads", [])]
        assert layers, w["name"]


def test_every_moves_names_an_end_to_end_metric_of_the_same_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["workloads"], m["name"]
        assert _line(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= _e2e_cells(e2e[m["moves"]])
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    # one name a layer, letter for letter
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("metric", [m for m in BENCH["per_layer"]
                                    if m["unit"] == "%"],
                         ids=lambda m: m["name"])
def test_shares_are_named_for_what_they_are(metric):
    name = metric["name"].split(".")[0]
    assert name.endswith("_roofline") or "mfu" in name \
        or name == "idle_share"

