"""Rename-commit: the atomic durable-write helper, the port of
``dryad_tpu/utils/atomic.py``.

Write a uniquely named temp file in the SAME directory as the target,
flush, ``os.fsync``, then ``os.replace`` it into place: readers see the
old complete file or the new complete one, never a partial write
(``os.replace`` is atomic only within one filesystem, hence the
same-directory temp name).  The temp name carries the pid, the thread id
and random bytes, so two writers racing on one target never share a temp
file; the last rename wins.
"""

from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from typing import Any, Iterator

__all__ = ["atomic_write", "atomic_write_bytes", "atomic_write_text",
           "atomic_write_json"]


def _tmp_path(path: str) -> str:
    d = os.path.dirname(os.path.abspath(path)) or "."
    return os.path.join(
        d, f".tmp-{os.getpid()}-{threading.get_ident()}-"
           f"{os.urandom(4).hex()}")


@contextmanager
def atomic_write(path: str, mode: str = "wb",
                 fsync: bool = True) -> Iterator[Any]:
    """Open a temp file for writing; commit it to ``path`` on a clean
    exit (flush + fsync + ``os.replace``).  On an exception the temp file
    is unlinked and ``path`` is untouched."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    tmp = _tmp_path(path)
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        # tmp is still there only on the exception path
        try:
            os.unlink(tmp)
        except OSError:
            pass


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    with atomic_write(path, "wb", fsync=fsync) as f:
        f.write(data)


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    with atomic_write(path, "w", fsync=fsync) as f:
        f.write(text)


def atomic_write_json(path: str, obj: Any, fsync: bool = True,
                      **json_kw: Any) -> None:
    with atomic_write(path, "w", fsync=fsync) as f:
        json.dump(obj, f, **json_kw)
