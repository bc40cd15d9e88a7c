"""64-bit FNV-1a over host bytes: the store's partition checksums.

The same function as the JAX package's (``dryad_tpu/native``), so either
package verifies the other's stores: fnv64 chained over a partition's
segments in file order, written as 16 hex digits.  The port's engine is
its own C source (``ops/csrc/host_fnv.c``), built at first use with the
host compiler (``ops/_build.host_library``); ``fnv64_py`` is the plain
version the tests hold it against.  A failed build raises: the store
never falls back to the Python loop, which takes minutes on a few
hundred MB.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

__all__ = ["FNV_BASIS", "fnv64_py", "fnv64", "checksum_segments"]

FNV_BASIS = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def fnv64_py(data: bytes, seed: int = FNV_BASIS) -> int:
    """The plain version: one byte at a time in Python."""
    h = seed
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def _lib():
    from dryad_tpu_torch.ops._build import host_library
    return host_library("host_fnv")


def fnv64(buf: np.ndarray, seed: int = FNV_BASIS) -> int:
    """fnv64 of a contiguous array's bytes, from ``seed``, in C."""
    view = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    return int(_lib().dryad_fnv64(view.ctypes.data_as(ctypes.c_void_p),
                                  view.nbytes, seed))


def checksum_segments(segments: Sequence[np.ndarray]) -> int:
    """fnv64 chained over a partition's segments, without concatenating
    them."""
    h = FNV_BASIS
    for s in segments:
        h = fnv64(s, h)
    return h
