"""``gpubench/parts.py`` and the readers of the per-pass and per-part
metrics, on a trace made by hand."""

import pytest

from gpubench import manifest
from gpubench.cells import Run
from gpubench.parts import owners, seconds, split, step_coverage
from gpubench.trace import STEP, WINDOW, Trace

MAIN, AUTOGRAD = 1, 2


def _range(name, tid, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def _op(corr, tid, launch, start, dur, name="kernel"):
    """A launch on ``tid`` at ``launch`` and its device operation."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": tid, "ts": launch, "dur": 1,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "tid": 7,
             "ts": start, "dur": dur, "args": {"correlation": corr}}]


def _step(t0, corr0):
    """One step at ``t0``: attention's forward (10 us), the FFN's backward
    (40 us, half of it a collective inside the range its op opens) with
    attention's recompute nested in it (20 us), an operation outside any
    program range on autograd's thread (5 us) and AdamW (8 us)."""
    c = corr0
    return [_range(STEP, MAIN, t0, 400),
            _range("attention", MAIN, t0 + 10, 40),
            *_op(c, MAIN, t0 + 20, t0 + 100, 10),
            _range("ffn.bwd", AUTOGRAD, t0 + 100, 200),
            _range("attention.remat", AUTOGRAD, t0 + 120, 80),
            *_op(c + 1, AUTOGRAD, t0 + 150, t0 + 160, 20),
            *_op(c + 2, AUTOGRAD, t0 + 250, t0 + 260, 20),
            _range("nccl:_reduce_scatter_base", AUTOGRAD, t0 + 270, 10),
            *_op(c + 5, AUTOGRAD, t0 + 275, t0 + 280, 20),
            *_op(c + 3, AUTOGRAD, t0 + 320, t0 + 330, 5),
            _range("adamw", MAIN, t0 + 340, 50),
            *_op(c + 4, MAIN, t0 + 345, t0 + 350, 8)]


def _run(events, steps=2):
    return Run({}, {}, Trace([_range(WINDOW, MAIN, 0, 1000)] + events),
               steps, {})


def _read(metric, run):
    return manifest.Manifest().reader(metric)(run)


def test_a_device_operation_goes_to_its_innermost_range():
    trace = _run(_step(0, 1) + _step(500, 11)).trace
    assert owners(trace)[:6] == ["attention", "attention.remat", "ffn.bwd",
                                 "ffn.bwd", None, "adamw"]
    got = seconds(trace)
    assert got == pytest.approx({("attention", "forward"): 20e-6,
                                 ("attention", "remat"): 40e-6,
                                 ("ffn", "bwd"): 80e-6,
                                 ("adamw", "forward"): 16e-6})
    # 5 us of each step's 83 fall in no program range
    assert step_coverage(trace) == pytest.approx(78 / 83)


@pytest.mark.parametrize("metric, ms", [
    ("forward_ms.train", 0.010), ("remat_ms.train", 0.020),
    ("backward_ms.train", 0.040), ("attention_ms.train", 0.030),
    ("ffn_ms.train", 0.040)])
def test_readers_give_device_ms_per_step(metric, ms):
    assert _read(metric, _run(_step(0, 1) + _step(500, 11))) == \
        pytest.approx(ms)


@pytest.mark.parametrize("metric", ["mamba_ms.train", "head_ms.train"])
def test_a_part_that_is_not_there_reads_nothing(metric):
    assert _read(metric, _run(_step(0, 1) + _step(500, 11))) is None


@pytest.mark.parametrize("metric", [
    "forward_ms.train", "remat_ms.train", "backward_ms.train",
    "attention_ms.train", "ffn_ms.train", "mamba_ms.train",
    "head_ms.train"])
def test_readers_find_nothing_without_ranges_or_passes(metric):
    plain = [e for e in _step(0, 1) if e["cat"] != "user_annotation"]
    assert _read(metric, _run(plain, steps=1)) is None
    # ranges without pass suffixes: a program that does not name passes
    unnamed = [dict(e, name=split(e["name"])[0])
               if e["cat"] == "user_annotation" else e
               for e in _step(0, 1)]
    assert _read(metric, _run(unnamed, steps=1)) is None
