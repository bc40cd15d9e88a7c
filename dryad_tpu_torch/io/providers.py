"""Multi-file text input — the local part of
``dryad_tpu/io/providers.py``: a path spec expands to a sorted file list
(one file, a glob, a directory, or a list of those), and the files are
read and line-packed in parallel on a host thread pool, in file order.
Remote schemes (``http://``, ``s3://``, ``hdfs://``) and the provider
registry wait for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import concurrent.futures
import glob as _glob
import os
from typing import List

import numpy as np

from dryad_tpu_torch.data.columnar import pack_lines

__all__ = ["expand_paths", "read_text_files"]


def expand_paths(spec) -> List[str]:
    """Expand a path spec into a sorted file list: a single file, a glob
    pattern (``*`` / ``?`` / ``[]``), a directory (every regular file in
    it), or a list of any of those."""
    if isinstance(spec, (list, tuple)):
        out: List[str] = []
        for s in spec:
            out.extend(expand_paths(s))
        if not out:
            raise FileNotFoundError("empty path list")
        return out
    if not isinstance(spec, str):
        raise TypeError(f"unsupported path spec {type(spec).__name__}")
    if "://" in spec:
        raise NotImplementedError(
            f"{spec}: the port reads local files only; remote providers "
            f"wait for ROADMAP Queue 1 item 10")
    if any(c in spec for c in "*?["):
        hits = sorted(_glob.glob(spec))
        if not hits:
            raise FileNotFoundError(f"pattern {spec!r} matched no files")
        return hits
    if os.path.isdir(spec):
        hits = sorted(os.path.join(spec, f) for f in os.listdir(spec)
                      if os.path.isfile(os.path.join(spec, f)))
        if not hits:
            raise FileNotFoundError(f"directory {spec!r} has no files")
        return hits
    if not os.path.exists(spec):
        raise FileNotFoundError(spec)
    return [spec]


def read_text_files(paths: List[str], max_line_len: int,
                    max_workers: int = 8):
    """Pack many text files into one (data [n, max_line_len] u8, lens [n]
    i32) matrix, the files read and packed in parallel, in file order.
    Returns (data, lens, per-file line counts)."""

    def pack_one(p: str):
        with open(p, "rb") as f:
            return pack_lines(f.read(), max_line_len)

    if len(paths) == 1:
        packed = [pack_one(paths[0])]
    else:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(max_workers, len(paths))) as pool:
            packed = list(pool.map(pack_one, paths))
    counts = [int(ln.shape[0]) for _, ln in packed]
    data = np.concatenate([d for d, _ in packed], axis=0)
    lens = np.concatenate([ln for _, ln in packed])
    return data, lens, counts
