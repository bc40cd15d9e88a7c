"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` file has a plain C interface and compiles with ``nvcc``
into its own shared library under ``build/kernels/`` at the root of the
checkout (a directory ``.gitignore`` lists), loaded with ``ctypes``.  A
library's file name carries a digest of its source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header never
loads a stale build.  ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them together; nothing is
built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build", "library", "KERNELS", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# kernel -> {C entry point: argtypes}; every entry point returns the
# cudaError_t of its launches as an int
KERNELS = {
    "hist_buckets": {"dryad_hist_buckets": [_P, _I, _LL, _I, _I, _P, _P, _P,
                                            _P]},
    "prefix_sum": {"dryad_prefix_sum_u32": [_P, _P, _LL, _P, _P],
                   "dryad_prefix_sum_f32": [_P, _P, _LL, _P, _P]},
    "prefix_sum2": {"dryad_prefix_sum2_f32": [_P, _P, _P, _LL, _P, _P]},
    "slot_expand": {"dryad_slot_expand": [_P, _I, _LL, _I, _P, _I, _I, _P,
                                          _P]},
    "slot_compact": {"dryad_slot_compact": [_P, _P, _I, _I, _I, _I, _LL,
                                            _P, _P]},
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the Hopper kernels build on first use")
    return found


def _lib_path(name: str) -> Path:
    """The library's path, named by a digest of its source, every shared
    ``csrc/*.cuh`` header (any of them may be included) and the flags."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile the named kernels that have no current library, one nvcc
    process per source, all running together.  Returns kernel -> the
    compiler's output (register and shared-memory use from -Xptxas -v),
    read from the build log when the library already existed."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for name in names:
        log = _lib_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in KERNELS[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib
