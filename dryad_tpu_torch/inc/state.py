"""A standing query's persisted state: one atomic state + watermark unit,
the port of ``dryad_tpu/inc/state.py`` (the same ``.npz`` layout, so a
state file committed by either package resumes in the other).

The key hashes the normalized query text, the base table's name and path
and its schema — not its row counts, which grow with every append — so a
restarted process finds the same file for the same standing query.  The
file holds the group-key columns, the raw state-aggregate columns in the
engine's dtypes (the merge adds in exactly the dtype the engine sums in),
and a JSON ``__meta__`` entry with the WATERMARK.  The commit is a temp
file and ``os.replace``: state and watermark move together, so a crash
mid-refresh leaves the previous pair intact and the next refresh scans
exactly the uncommitted delta.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dryad_tpu_torch.utils.atomic import atomic_write

__all__ = ["state_key", "state_path", "load_state", "commit_state"]

_META = "__meta__"
_COL = "c:"


def state_key(norm_query: str, table: str, path: Optional[str],
              schema: Dict[str, Any]) -> str:
    """The 16-hex fingerprint naming one standing query's state file."""
    blob = json.dumps({"sql": norm_query, "table": table,
                       "path": path, "schema": schema},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def state_path(state_dir: str, key: str) -> str:
    return os.path.join(state_dir, f"state-{key}.npz")


def load_state(path: str) -> Optional[Tuple[int, Dict[str, Any]]]:
    """``(watermark, columns)`` of a committed state file, or None when
    no refresh has committed.  A string key column comes back as an
    ``S``-dtype array, a numeric one in its committed dtype."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META]).decode())
        cols = {name: np.array(z[_COL + name])
                for name in meta["columns"]}
    return int(meta["watermark"]), cols


def commit_state(path: str, watermark: int,
                 columns: Dict[str, Any]) -> None:
    """Atomically publish ``(watermark, columns)``: numpy arrays of equal
    length (a string column as ``S`` dtype)."""
    arrays = {_META: np.frombuffer(
        json.dumps({"watermark": int(watermark),
                    "columns": sorted(columns)}).encode(), np.uint8)}
    for name, arr in columns.items():
        arrays[_COL + name] = np.asarray(arr)
    with atomic_write(path, "wb") as f:
        np.savez(f, **arrays)
