"""dryad_tpu_torch/ops/_build.py on the CPU: a library's file name digests
its source, every shared csrc/*.cuh header and the nvcc flags, so an
edited source or header never loads a stale build.  (The build itself
needs nvcc and runs in chip_smoke.py.)"""

import re

import pytest

from dryad_tpu_torch.ops import _build
from tests.torch_threads import one_torch_thread  # noqa: F401


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


def test_concurrent_first_library_calls_build_once(csrc, tmp_path,
                                                   monkeypatch):
    """Eight threads released together ask for a kernel that has no
    library yet: one builds it (``build`` and ``ctypes.CDLL`` replaced by
    fakes), the rest wait and get the same loaded library."""
    import threading
    import time

    built, loaded = [], []
    out = tmp_path / "out"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "KERNELS", {"k": {"dryad_k": []}})
    monkeypatch.setattr(_build, "_LOADED", {})

    def fake_build(names):
        built.append(list(names))
        time.sleep(0.05)          # a slow nvcc: the others arrive now
        out.mkdir(parents=True, exist_ok=True)
        _build._lib_path("k").write_bytes(b"lib")

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)
            self.dryad_k = type("F", (), {})()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(8)
    libs = []

    def first_use():
        barrier.wait(timeout=30)
        libs.append(_build.library("k"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert built == [["k"]] and len(loaded) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_temp_names_differ_across_threads_and_calls(tmp_path):
    """Two builders of one library, in one process or two, never write
    the same temp file."""
    import threading

    path = tmp_path / "libk-0.so"
    names = [_build._tmp_of(path), _build._tmp_of(path)]
    t = threading.Thread(target=lambda: names.append(_build._tmp_of(path)))
    t.start()
    t.join(timeout=30)
    assert len(set(names)) == 3
    assert all(n.parent == tmp_path and n.suffix == ".tmp" for n in names)


FAKE_NVCC = """#!/bin/sh
# records each compile, takes a while, writes the -o file
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$out" >> "$FAKE_NVCC_CALLS"
sleep 0.3
echo lib > "$out"
echo "ptxas info : fake"
"""


def test_two_processes_build_each_library_once(tmp_path):
    """Two processes released together on an empty build directory (the
    worker processes of a cluster started on a fresh checkout) both ask
    for every kernel, ``nvcc`` a fake that records each compile: each
    library is compiled once, by whichever process holds the directory's
    lock, and both processes get the same libraries and logs."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    (bindir / "nvcc").write_text(FAKE_NVCC)
    (bindir / "nvcc").chmod(0o755)
    calls = tmp_path / "calls"
    out = tmp_path / "kernels"
    root = Path(_build.__file__).resolve().parents[2]
    code = ("import sys, time\n"
            "from pathlib import Path\n"
            "from dryad_tpu_torch.ops import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "while time.time() < float(sys.argv[2]):\n"
            "    time.sleep(0.005)\n"
            "logs = _build.build()\n"
            "print(sorted((k, _build._lib_path(k).name, v) "
            "for k, v in logs.items()))\n")
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               FAKE_NVCC_CALLS=str(calls),
               PYTHONPATH=str(root))
    import time
    go = str(time.time() + 8.0)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out), go],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    res = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [r[1] for r in res]
    compiled = calls.read_text().split()
    assert len(compiled) == len(_build.KERNELS)
    assert len({Path(c).name.split("-")[0] for c in compiled}) == \
        len(_build.KERNELS)
    assert res[0][0] == res[1][0] and "ptxas info : fake" in res[0][0]
    assert sorted(p.name for p in out.glob("*.so")) == sorted(
        _build._lib_path(k).name for k in _build.KERNELS)
