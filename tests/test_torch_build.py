"""The kernel build cache: a library's name covers everything compiled into
it (its source, every shared ``csrc/*.cuh`` header and the nvcc flags), so
a stale library is never loaded.  Needs no nvcc: only names are compared."""

import pytest

from repro_torch.kernels import _build


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
