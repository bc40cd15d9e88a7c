"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` file has a plain C interface and compiles with ``nvcc``
into its own shared library under ``build/kernels/`` at the root of the
checkout (a directory ``.gitignore`` lists), loaded with ``ctypes``.  A
library's file name carries a digest of its source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header never
loads a stale build.  ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them together; nothing is
built at import time.

The host side has C sources of its own (``csrc/*.c``, ``HOST``: the
store's FNV-1a checksum).  ``host_library`` compiles one with the host C
compiler (``$CC``, else ``cc``) into ``build/host/`` at first use, named
by the same kind of digest, and loads it with ``ctypes``.  A failed
build raises with the compiler's message.  Each library is built and
loaded once per process, under a lock (the job service's fleet threads
may be the first to need a kernel at once), and once per build
directory across processes: the compiling process holds an exclusive
``flock`` on a ``.<directory>.lock`` file beside it, so the worker
processes of a cluster started on a fresh checkout build each library
once and the others load it.  Every compiler still writes a temp file
of its own (process, thread and a counter in its name) that is renamed
into place, so no process ever loads a torn file.  The names stay
unique because the lock is advisory: where ``flock`` does not exclude
(some network and FUSE file systems grant it to every caller), two
processes may both compile a library, and each must rename a whole
file of its own into place.
``compile_seconds()`` is the process's total wall spent compiling (nvcc
and cc): the executor reports each stage attempt's share as its
``compile_s``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build", "library", "host_library", "compile_seconds",
           "KERNELS", "HOST", "BUILD_DIR", "HOST_BUILD_DIR", "NVCC_FLAGS",
           "CC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"

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
    "hash_keys": {"dryad_hash_keys": [_P, _I, _LL, _P, _I, _P, _P,
                                       _P]},
    "seg_scan": {"dryad_seg_scan": [_P, _I, _LL, _P, _P, _P, _P]},
}

# host C library -> {entry point: (argtypes, restype)}
HOST = {
    "host_fnv": {"dryad_fnv64": ([_P, _LL, ctypes.c_uint64],
                                 ctypes.c_uint64)},
}
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c11")

_LOADED: Dict[str, ctypes.CDLL] = {}
_HOST_LOADED: Dict[str, ctypes.CDLL] = {}
# the first use of a kernel can come from several threads at once (the
# job service's fleet): one builds and loads it, the others wait
_LIB_LOCK = threading.RLock()
# the store checksums partitions on a thread pool, so the first use of a
# host library can come from several threads at once: one builds
_HOST_LOCK = threading.Lock()
_TMP_SEQ = itertools.count()
# seconds this process has spent waiting for compilers
_COMPILE_S = [0.0]
_COMPILE_LOCK = threading.Lock()


def compile_seconds() -> float:
    """Total wall this process has spent compiling kernels and host
    libraries (0.0 while every library was already built)."""
    return _COMPILE_S[0]


def _add_compile_s(seconds: float) -> None:
    with _COMPILE_LOCK:
        _COMPILE_S[0] += seconds


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


def _tmp_of(path: Path) -> Path:
    """A temp path beside ``path`` that no other process, thread or call
    uses."""
    return path.with_suffix(f".{os.getpid()}-{threading.get_ident()}-"
                            f"{next(_TMP_SEQ)}.tmp")


@contextlib.contextmanager
def _dir_lock(d: Path):
    """One compiling process per directory: an exclusive flock on
    ``.<name>.lock`` beside the directory ``d`` for the scope (released
    when the file closes, a killed holder's too); ``d`` holds only the
    libraries and their logs."""
    d.mkdir(parents=True, exist_ok=True)
    with open(d.parent / f".{d.name}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile the named kernels that have no current library, one nvcc
    process per source, all running together.  Returns kernel -> the
    compiler's output (register and shared-memory use from -Xptxas -v),
    read from the build log when the library already existed."""
    with _LIB_LOCK, _dir_lock(BUILD_DIR):
        return _build(list(names))


def _build(names) -> Dict[str, str]:
    """Compile the missing ones (the caller holds the directory's
    lock: a library another process built meanwhile exists now)."""
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = _tmp_of(out)
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
    if procs:
        _add_compile_s(time.perf_counter() - t0)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for name in names:
        log = _lib_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed (once
    per process: concurrent first callers wait for one build)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LIB_LOCK:
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


def _compile_host(name: str, path: Path) -> None:
    tmp = _tmp_of(path)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_cc(), *CC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.c")],
        capture_output=True, text=True)
    _add_compile_s(time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name}.c failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def _cc() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no host C compiler (set CC, or put cc on "
                           "PATH); the store's checksum builds on first "
                           "use")
    return cc


def _host_lib_path(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.c").read_bytes())
    h.update(" ".join(CC_FLAGS).encode())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host C library ``name`` (a key of ``HOST``), compiled
    first if it has no current build.  Raises RuntimeError with the
    compiler's output when the build fails."""
    lib = _HOST_LOADED.get(name)
    if lib is not None:
        return lib
    with _HOST_LOCK:
        lib = _HOST_LOADED.get(name)
        if lib is not None:
            return lib
        path = _host_lib_path(name)
        if not path.exists():
            with _dir_lock(HOST_BUILD_DIR):
                if not path.exists():   # another process built it
                    _compile_host(name, path)
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in HOST[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _HOST_LOADED[name] = lib
        return lib
