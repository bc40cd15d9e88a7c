"""dryad_tpu_torch/ops/_build.py on the CPU: a library's file name digests
its source, every shared csrc/*.cuh header and the nvcc flags, so an
edited source or header never loads a stale build.  (The build itself
needs nvcc and runs in chip_smoke.py.)"""

import re

import pytest

from dryad_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\nint k;\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\nint shared;\n")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    return tmp_path


def test_edited_header_changes_the_library_path(csrc):
    before = _build._lib_path("k")
    (csrc / "shared.cuh").write_text("#pragma once\nint shared2;\n")
    after = _build._lib_path("k")
    assert after != before
    assert after.name.startswith("libk-") and after.suffix == ".so"


def test_edited_source_new_header_or_flags_change_the_path(csrc, monkeypatch):
    seen = {_build._lib_path("k")}
    (csrc / "k.cu").write_text('#include "shared.cuh"\nint k2;\n')
    seen.add(_build._lib_path("k"))
    (csrc / "other.cuh").write_text("int other;\n")
    seen.add(_build._lib_path("k"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    seen.add(_build._lib_path("k"))
    assert len(seen) == 4


def test_same_inputs_same_path_and_other_files_ignored(csrc):
    before = _build._lib_path("k")
    (csrc / "notes.txt").write_text("not a source\n")
    assert _build._lib_path("k") == before


def test_every_include_of_the_sources_is_a_digested_header():
    """A source includes only system headers and csrc/*.cuh files, so the
    digest covers every file a build reads from the checkout."""
    headers = {p.name for p in _build._CSRC.glob("*.cuh")}
    for name in _build.KERNELS:
        src = (_build._CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include "([^"]+)"', src):
            assert inc in headers, (name, inc)
