"""The job service's on-disk bytes cache — the port of the
``FileCache`` half of ``dryad_tpu/utils/compile_cache.py``.

The JAX module also turns on XLA's persistent compilation cache; the
port compiles its kernels once into ``build/kernels/``
(``ops/_build.py``), so that half is not ported.  ``FileCache`` holds
the service's serialized plans (``service/daemon.py``): every commit is
a same-directory atomic rename, so a reader sees the old complete entry
or the new one; every entry is ``magic + sha256(payload) + payload``, so
a torn or corrupt file reads as a miss (and is unlinked); two writers of
one key race benignly, the last rename winning.  Hits and misses count
in the metrics registry (``cache_hits`` / ``cache_misses``, labelled
``cache="file"``, and the job when given).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

__all__ = ["FileCache"]

# 8-byte magic + sha256 of the payload, the JAX package's entry format
_FC_MAGIC = b"DRYDFC1\n"


class FileCache:
    """Concurrent-writer-safe on-disk bytes cache (get / put by string
    key; see the module docstring)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        h = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self.root, h[:2], h[2:])

    def _count(self, hit: bool, job: Optional[str]) -> None:
        from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
        labels = {"cache": "file"}
        if job is not None:
            labels["job"] = job
        family_counter(REGISTRY, "cache_hits" if hit else "cache_misses",
                       **labels).inc()

    def get(self, key: str, job: Optional[str] = None) -> Optional[bytes]:
        """The committed payload for ``key``, or None (a miss, or a torn
        entry)."""
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                blob = f.read()
                ino = os.fstat(f.fileno()).st_ino
        except OSError:
            self._count(False, job)
            return None
        head = len(_FC_MAGIC) + 32
        if (len(blob) < head or not blob.startswith(_FC_MAGIC)
                or hashlib.sha256(blob[head:]).digest()
                != blob[len(_FC_MAGIC):head]):
            # a torn entry is a miss; evict it, but only the inode read (a
            # concurrent put may have renamed a valid entry in since)
            try:
                if os.stat(p).st_ino == ino:
                    os.unlink(p)
            except OSError:
                pass
            self._count(False, job)
            return None
        self._count(True, job)
        return blob[head:]

    def put(self, key: str, data: bytes, job: Optional[str] = None) -> None:
        """Commit ``data`` under ``key`` atomically (rename commit)."""
        from dryad_tpu_torch.utils.atomic import atomic_write_bytes
        blob = _FC_MAGIC + hashlib.sha256(data).digest() + data
        atomic_write_bytes(self._path(key), blob)
