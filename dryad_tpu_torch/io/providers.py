"""URI-scheme data providers and multi-file text input — the port of
``dryad_tpu/io/providers.py``.

A path spec expands to a sorted file list (one file, a glob, a directory,
or a list of those), and the files are read and line-packed in parallel on
a host thread pool, in file order.  ``Context.read(uri)`` dispatches on
the URI's scheme: ``file://`` text, ``store://`` a partitioned store,
``http://`` ranged GETs (``io/http_provider.py``), ``s3://`` every object
under a prefix (``io/s3.py``), ``hdfs://`` WebHDFS (``io/webhdfs.py``),
and any scheme added with ``register_provider``.  A remote provider hands
``text_dataset_from_fetches`` one fetch function per partition; the
fetches run and their lines pack in parallel.  ``expand_uris`` and
``open_blocks`` give the streamed text reader (``exec/ooc.py``) the same
schemes, a bounded block at a time.
"""

from __future__ import annotations

import concurrent.futures
import glob as _glob
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.data.columnar import pack_lines

__all__ = ["register_provider", "parse_uri", "expand_paths",
           "expand_uris", "open_blocks", "read_text_files",
           "text_dataset_from_fetches", "retry_transient", "open_uri",
           "UnknownSchemeError"]


# retry_transient's first wait in seconds when none is given (it doubles
# per retry, up to 2 s)
RETRY_BACKOFF_S = 0.2


class UnknownSchemeError(ValueError):
    pass


def retry_transient(fn: Callable[[], Any], what: str = "",
                    retries: int = 3,
                    base_delay_s: Optional[float] = None) -> Any:
    """Run an IDEMPOTENT multi-request read with bounded exponential
    backoff on transient failures (an empty body, a truncated stream, a
    connection dropped between hops), which may slip past the
    per-request retries of the provider clients: the whole read is
    issued again.  An error carrying a 4xx ``status`` is definite and
    raises at once; the last transient failure raises once ``retries``
    are spent."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except (IOError, OSError, ConnectionError) as e:
            status = getattr(e, "status", None)
            if status is not None and 400 <= int(status) < 500:
                raise
            if attempt >= retries:
                raise
            base = (RETRY_BACKOFF_S if base_delay_s is None
                    else base_delay_s)
            time.sleep(min(base * (2 ** attempt), 2.0))


def parse_uri(uri: str) -> Tuple[str, str]:
    """"scheme://rest" -> (scheme, rest); a bare path -> ("file", path)."""
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme.lower(), rest
    return "file", uri


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


def expand_uris(spec) -> List[str]:
    """``expand_paths`` for text that may be remote: a ``http://`` URL
    ending in ``/`` lists its partition files, an ``s3://`` prefix
    ending in ``/`` every object under it, an ``hdfs://`` directory every
    file in it (sorted); any other URI is itself, and a local spec is
    ``expand_paths``'s."""
    if isinstance(spec, (list, tuple)):
        return [u for s in spec for u in expand_uris(s)]
    if not (isinstance(spec, str) and "://" in spec):
        return expand_paths(spec)
    scheme, rest = parse_uri(spec)
    if scheme == "http":
        from dryad_tpu_torch.io.http_provider import enumerate_http
        return enumerate_http(spec)
    if scheme == "s3" and spec.endswith("/"):
        from dryad_tpu_torch.io.s3 import parse_s3_url
        from dryad_tpu_torch.io.s3_store import s3_client
        bucket, prefix = parse_s3_url(spec)
        keys = [k for k, _ in s3_client().list_objects(bucket, prefix)]
        if not keys:
            raise FileNotFoundError(f"no objects under {spec}")
        return [f"s3://{bucket}/{k}" for k in keys]
    if scheme == "hdfs":
        from dryad_tpu_torch.io.webhdfs import hdfs_client
        c, path = hdfs_client(spec)
        path = path.rstrip("/") or "/"
        if c.status(path).get("type") == "DIRECTORY":
            names = sorted(e["pathSuffix"] for e in c.list_status(path)
                           if e.get("type") == "FILE")
            if not names:
                raise FileNotFoundError(f"hdfs directory {spec!r} has no "
                                        f"files")
            head = spec.rstrip("/")
            return [head + "/" + n for n in names]
    return [spec]


def open_blocks(uri: str, block: int) -> Iterator[bytes]:
    """A file's bytes in order, at most ``block`` bytes at a time: a
    local file by reads, a ``http://`` / ``s3://`` / ``hdfs://`` one by
    ranged requests (one whole-body GET from an HTTP server without
    range support)."""
    scheme, rest = parse_uri(uri)
    if scheme == "file":
        with open(rest, "rb") as f:
            while True:
                blk = f.read(block)
                if not blk:
                    return
                yield blk
    if scheme == "http":
        from dryad_tpu_torch.io.http_provider import iter_url_blocks
        yield from iter_url_blocks(uri, block)
        return
    if scheme == "s3":
        from dryad_tpu_torch.io.s3 import parse_s3_url
        from dryad_tpu_torch.io.s3_store import s3_client
        c = s3_client()
        bucket, key = parse_s3_url(uri)
        size = c.head_size(bucket, key)
        for off in range(0, size, block):
            yield c.get_object(bucket, key,
                               rng=(off, min(off + block, size) - 1))
        return
    if scheme == "hdfs":
        from dryad_tpu_torch.io.webhdfs import _read_exact, hdfs_client
        c, path = hdfs_client(uri)
        size = int(c.status(path)["length"])
        for off in range(0, size, block):
            yield _read_exact(c, path, off, min(block, size - off), block)
        return
    raise UnknownSchemeError(f"no block reader for scheme {scheme!r}")


def _pack_all(fetchers: List[Callable[[], bytes]], max_line_len: int,
              max_workers: int = 8):
    """Fetch and line-pack every partition, in parallel, in order:
    (data [n, max_line_len] u8, lens [n] i32, per-partition counts)."""

    def pack(fetch):
        return pack_lines(fetch(), max_line_len)

    if len(fetchers) == 1:
        packed = [pack(fetchers[0])]
    else:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(max_workers, len(fetchers))) as pool:
            packed = list(pool.map(pack, fetchers))
    counts = [int(ln.shape[0]) for _, ln in packed]
    data = np.concatenate([d for d, _ in packed], axis=0)
    lens = np.concatenate([ln for _, ln in packed])
    return data, lens, counts


def read_text_files(paths: List[str], max_line_len: int,
                    max_workers: int = 8):
    """Pack many text files into one (data [n, max_line_len] u8, lens [n]
    i32) matrix, the files read and packed in parallel, in file order.
    Returns (data, lens, per-file line counts)."""

    def reader(p: str):
        def read() -> bytes:
            with open(p, "rb") as f:
                return f.read()
        return read

    return _pack_all([reader(p) for p in paths], max_line_len, max_workers)


def text_dataset_from_fetches(ctx, fetchers: List[Callable[[], bytes]],
                              column: str,
                              max_line_len: Optional[int] = None):
    """The shared tail of every remote text provider: each fetcher
    returns one partition's raw bytes; the partitions are fetched and
    line-packed in parallel and become one text Dataset on the context's
    device (with the lines on the host as well under ``local_debug``,
    for the oracle)."""
    from dryad_tpu_torch.exec.data import pdata_from_packed_strings
    max_line_len = max_line_len or ctx.config.text_max_line_len
    data, lens, _ = _pack_all(fetchers, max_line_len)
    host = ({column: [bytes(r[:n]) for r, n in zip(data, lens)]}
            if ctx.local_debug else None)
    return ctx.from_pdata(pdata_from_packed_strings(data, lens, ctx.mesh,
                                                    column=column),
                          host=host)


# -- the scheme registry ----------------------------------------------------

# provider: fn(ctx, rest, **kw) -> Dataset
_PROVIDERS: Dict[str, Callable[..., Any]] = {}


def register_provider(scheme: str, fn: Callable[..., Any]) -> None:
    """Register (or replace) the provider of a URI scheme."""
    _PROVIDERS[scheme.lower()] = fn


def open_uri(ctx, uri: str, **kw):
    scheme, rest = parse_uri(uri)
    fn = _PROVIDERS.get(scheme)
    if fn is None:
        raise UnknownSchemeError(
            f"no data provider for scheme {scheme!r} (known: "
            f"{sorted(_PROVIDERS)}); register one with "
            f"io.providers.register_provider")
    return fn(ctx, rest, **kw)


def _file_provider(ctx, rest: str, **kw):
    return ctx.read_text(rest, **kw)


def _store_provider(ctx, rest: str, **kw):
    return ctx.from_store(rest, **kw)


def _http_provider(ctx, rest: str, **kw):
    from dryad_tpu_torch.io.http_provider import http_provider
    return http_provider(ctx, rest, **kw)


def _s3_provider(ctx, rest: str, column: str = "line",
                 max_line_len: Optional[int] = None, **kw):
    """``ctx.read("s3://bucket/prefix/")``: every object under the prefix
    (listed page by page) is a text partition, in key order."""
    from dryad_tpu_torch.io.s3 import parse_s3_url
    from dryad_tpu_torch.io.s3_store import s3_client

    bucket, prefix = parse_s3_url("s3://" + rest)
    c = s3_client(kw.pop("s3_config", None))
    keys = [k for k, _sz in c.list_objects(bucket, prefix)]
    if not keys:
        raise FileNotFoundError(f"no objects under s3://{bucket}/{prefix}")
    return text_dataset_from_fetches(
        ctx, [lambda k=k: c.get_object(bucket, k) for k in keys],
        column, max_line_len)


def _hdfs_provider(ctx, rest: str, **kw):
    from dryad_tpu_torch.io.webhdfs import hdfs_provider
    return hdfs_provider(ctx, rest, **kw)


register_provider("file", _file_provider)
register_provider("store", _store_provider)
register_provider("http", _http_provider)
register_provider("s3", _s3_provider)
register_provider("hdfs", _hdfs_provider)
