"""The kernel build cache: a library's name covers everything compiled into
it (its source, every shared ``csrc/*.cuh`` header and the nvcc flags), so
a stale library is never loaded; and the K4-bwd probe's variants, text
substitutions into the current source.  Needs no nvcc: only names and
texts are compared."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.kernels import _build


def _probe():
    path = Path(__file__).resolve().parents[1] / "tools" / "ssd_bwd_probe.py"
    spec = importlib.util.spec_from_file_location("ssd_bwd_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PROBE = _probe()


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", list(_build.NVCC_FLAGS))
    return tmp_path


def test_library_path_is_stable_and_named_by_source(csrc):
    first = _build.library_path(csrc / "a.cu")
    assert first == _build.library_path(csrc / "a.cu")
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("liba-") and first.suffix == ".so"
    assert _build.sources() == [csrc / "a.cu", csrc / "b.cu"]


@pytest.mark.parametrize("edit", ["source", "header", "new header", "flags"])
def test_library_path_changes_with_what_is_compiled(csrc, edit):
    before = _build.library_path(csrc / "a.cu")
    if edit == "source":
        (csrc / "a.cu").write_text('#include "common.cuh"\nint a2;\n')
    elif edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\n#define X 1\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        _build.NVCC_FLAGS.append("-lineinfo")
    assert _build.library_path(csrc / "a.cu") != before


@pytest.mark.parametrize("edit", ["other source", "python file", "touch"])
def test_library_path_ignores_what_is_not_compiled(csrc, edit):
    before = _build.library_path(csrc / "a.cu")
    if edit == "other source":
        (csrc / "b.cu").write_text("int b2;\n")
    elif edit == "python file":
        (csrc / "notes.py").write_text("x = 1\n")
    else:
        (csrc / "a.cu").write_text((csrc / "a.cu").read_text())
    assert _build.library_path(csrc / "a.cu") == before


@pytest.mark.parametrize("variant", list(PROBE.VARIANTS))
def test_probe_variant_finds_its_text_once(variant):
    """tools/ssd_bwd_probe.py builds each variant by substituting texts
    into ssd_scan_bwd.cu: each must occur there exactly once, so an edit
    of the kernel that moves one fails here and not on the card."""
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    out = PROBE.apply(src, variant, PROBE.VARIANTS[variant])
    assert (out == src) == (not PROBE.VARIANTS[variant])


def test_probe_refuses_a_text_it_cannot_find():
    with pytest.raises(ValueError, match="not once"):
        PROBE.apply("int a;\n", "v", [("int b;", "")])
