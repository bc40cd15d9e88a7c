"""WebHDFS (``hdfs://``) storage adapter — the port of
``dryad_tpu/io/webhdfs.py``.

It speaks the WebHDFS REST dialect (the namenode's HTTP gateway, served
by every stock namenode and by HttpFS proxies) with the standard library
alone:

* the namenode -> datanode 307 redirect: OPEN / CREATE / APPEND move
  bytes on the datanode hop only;
* ranged reads (``op=OPEN&offset=&length=``), so a partition passes
  through host memory in bounded pieces;
* ``GETFILEBLOCKLOCATIONS``: block -> host hints, hosts holding more of
  a partition's bytes first;
* bounded exponential-backoff retries on 5xx and connection errors;
* the store layout of ``io/store.py`` (``part-NNNNN.bin`` and
  ``meta.json``) committed by HDFS's atomic rename of a temp directory,
  as the local store commits.

``hdfs://namenode:port/path`` addresses the endpoint
``http://namenode:port/webhdfs/v1/path``.  ``io/store.py`` sends every
``hdfs://`` store here, ``io/providers.py`` registers the scheme for
``Context.read``.  Every ranged read is one ``hdfs.open`` io span and
every file written one ``hdfs.create`` span.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import json
import os
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["WebHdfsClient", "WebHdfsError", "parse_hdfs_url",
           "hdfs_client", "hdfs_store_meta", "hdfs_write_store",
           "hdfs_read_part_views", "hdfs_part_chunks", "hdfs_part_path",
           "hdfs_preferred_hosts", "hdfs_provider"]

# bytes per ranged read
_RANGE_BLOCK = 2 << 20
_TIMEOUT_S = 60.0
_MAX_REDIRECTS = 4
# a client's first retry wait in seconds (it doubles per retry, up to 2 s)
BACKOFF_S = 0.1


class WebHdfsError(IOError):
    """A non-retryable WebHDFS failure (4xx, a protocol violation, or
    retries exhausted).  ``status`` is the HTTP code when one came; the
    message carries the namenode's RemoteException when the body held
    one."""

    def __init__(self, msg: str, status: Optional[int] = None):
        super().__init__(msg)
        self.status = status


def parse_hdfs_url(url: str) -> Tuple[str, str]:
    """hdfs://namenode:port/path -> ("http://namenode:port", "/path")."""
    if not url.startswith("hdfs://"):
        raise ValueError(f"not an hdfs url: {url!r}")
    authority, _, path = url[len("hdfs://"):].partition("/")
    if not authority:
        raise ValueError(f"hdfs url has no namenode authority: {url!r}")
    return "http://" + authority, "/" + path


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """A WebHDFS redirect is protocol: the datanode Location is followed
    by hand (data ships on the second hop only)."""

    def redirect_request(self, *a, **kw):
        return None


_OPENER = urllib.request.build_opener(_NoRedirect)


def _remote_exception(body: bytes) -> str:
    try:
        exc = json.loads(body)["RemoteException"]
        return f"{exc.get('exception')}: {exc.get('message')}"
    except Exception:
        return body[:200].decode("utf-8", "replace")


class WebHdfsClient:
    """A minimal WebHDFS REST client.  ``user`` rides as ``user.name`` on
    every request (HDFS simple auth; ``HADOOP_USER_NAME`` when unset)."""

    def __init__(self, base_url: str, user: Optional[str] = None,
                 timeout_s: float = _TIMEOUT_S, max_retries: int = 3):
        self.base = base_url.rstrip("/")
        self.user = user or os.environ.get("HADOOP_USER_NAME")
        self.timeout_s = timeout_s
        self.max_retries = max_retries

    # -- request plumbing --------------------------------------------------

    def _url(self, path: str, op: str, **params) -> str:
        if not path.startswith("/"):
            path = "/" + path
        q: List[Tuple[str, str]] = [("op", op)]
        if self.user:
            q.append(("user.name", self.user))
        q.extend((k, str(v)) for k, v in params.items() if v is not None)
        return (self.base + "/webhdfs/v1"
                + urllib.parse.quote(path, safe="/")
                + "?" + urllib.parse.urlencode(q))

    @staticmethod
    def _backoff(attempt: int) -> None:
        time.sleep(min(BACKOFF_S * 2 ** attempt, 2.0))

    def _attempt(self, method: str, url: str, data: Optional[bytes],
                 retries: Optional[int] = None
                 ) -> Tuple[int, bytes, Optional[str]]:
        """One HTTP exchange, retried on 5xx and connection errors:
        (status, body, redirect location).  ``retries`` overrides the
        client's (0 for a hop that is not idempotent)."""
        max_retries = self.max_retries if retries is None else retries
        last: Optional[BaseException] = None
        for attempt in range(max_retries + 1):
            req = urllib.request.Request(url, data=data, method=method)
            if data is not None:
                req.add_header("Content-Type", "application/octet-stream")
            try:
                with _OPENER.open(req, timeout=self.timeout_s) as r:
                    return r.getcode(), r.read(), None
            except urllib.error.HTTPError as e:
                body = e.read()
                loc = e.headers.get("Location")
                if e.code in (301, 302, 303, 307) and loc:
                    return e.code, body, loc
                if e.code >= 500 and attempt < max_retries:
                    last = e
                    self._backoff(attempt)
                    continue
                raise WebHdfsError(
                    f"webhdfs {method} {url} failed: HTTP {e.code} "
                    f"({_remote_exception(body)})", status=e.code) from e
            except (urllib.error.URLError, socket.timeout, TimeoutError,
                    ConnectionError) as e:
                if attempt < max_retries:
                    last = e
                    self._backoff(attempt)
                    continue
                raise WebHdfsError(
                    f"webhdfs {method} {url} unreachable after "
                    f"{max_retries + 1} attempts: {e}") from e
        raise WebHdfsError(f"webhdfs {method} {url} failed: {last}")

    def _read_op(self, method: str, url: str) -> Tuple[int, bytes]:
        """A body-less op, following the namenode -> datanode
        redirect."""
        for _hop in range(_MAX_REDIRECTS):
            status, body, loc = self._attempt(method, url, None)
            if loc is None:
                return status, body
            url = loc
        raise WebHdfsError(f"webhdfs {method}: too many redirects at {url}")

    def _data_op(self, method: str, url: str, data: bytes,
                 data_retries: Optional[int] = None) -> Tuple[int, bytes]:
        """A two-step write: the namenode request carries no body and
        must redirect to a datanode, which alone gets the data.
        ``data_retries`` bounds the data hop's retries (0 for APPEND: a
        lost reply after an applied append must not send the bytes
        again)."""
        status, body, loc = self._attempt(method, url, None)
        if loc is None:
            raise WebHdfsError(
                f"webhdfs {method} {url}: namenode did not redirect to a "
                f"datanode (HTTP {status}); data was NOT written",
                status=status)
        status, body, loc = self._attempt(method, loc, data,
                                          retries=data_retries)
        if loc is not None:
            raise WebHdfsError(
                f"webhdfs {method}: datanode redirected again ({loc})")
        return status, body

    def _json(self, method: str, path: str, op: str, **params
              ) -> Dict[str, Any]:
        _status, body = self._read_op(method, self._url(path, op, **params))
        return json.loads(body) if body.strip() else {}

    # -- filesystem ops ----------------------------------------------------

    def status(self, path: str) -> Dict[str, Any]:
        """GETFILESTATUS -> the FileStatus dict (length, type, ...)."""
        return self._json("GET", path, "GETFILESTATUS")["FileStatus"]

    def list_status(self, path: str) -> List[Dict[str, Any]]:
        """LISTSTATUS -> the children's FileStatus list."""
        return (self._json("GET", path, "LISTSTATUS")
                ["FileStatuses"]["FileStatus"])

    def exists(self, path: str) -> bool:
        try:
            self.status(path)
            return True
        except WebHdfsError as e:
            if e.status == 404:
                return False
            raise

    def mkdirs(self, path: str) -> bool:
        return bool(self._json("PUT", path, "MKDIRS").get("boolean"))

    def delete(self, path: str, recursive: bool = False) -> bool:
        return bool(self._json("DELETE", path, "DELETE",
                               recursive=str(bool(recursive)).lower()
                               ).get("boolean"))

    def rename(self, src: str, dst: str) -> None:
        if not self._json("PUT", src, "RENAME",
                          destination=dst).get("boolean"):
            raise WebHdfsError(f"webhdfs rename {src!r} -> {dst!r} refused")

    def open(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        """A ranged read through the datanode redirect; one
        ``hdfs.open`` io span."""
        from dryad_tpu_torch.obs import trace
        with trace.span("hdfs.open", "io", path=path,
                        offset=offset) as sp:
            _status, body = self._read_op(
                "GET", self._url(path, "OPEN", offset=offset,
                                 length=length))
            sp.set(bytes=len(body))
        return body

    def read_all(self, path: str, block: int = _RANGE_BLOCK) -> bytes:
        """A whole file by bounded ranged reads, never one unbounded
        GET."""
        size = int(self.status(path)["length"])
        return _read_exact(self, path, 0, size, block)

    def create(self, path: str, data: bytes, overwrite: bool = True
               ) -> None:
        from dryad_tpu_torch.obs import trace
        with trace.span("hdfs.create", "io", path=path, bytes=len(data)):
            self._data_op("PUT", self._url(
                path, "CREATE", overwrite=str(bool(overwrite)).lower()),
                data)

    def append(self, path: str, data: bytes) -> None:
        """APPEND is not idempotent: its data hop never retries."""
        self._data_op("POST", self._url(path, "APPEND"), data,
                      data_retries=0)

    def block_locations(self, path: str, offset: int = 0,
                        length: Optional[int] = None
                        ) -> List[Dict[str, Any]]:
        """GETFILEBLOCKLOCATIONS -> [{"offset", "length", "hosts"}, ...];
        an empty list where the namenode answers 4xx (locality is a
        hint)."""
        try:
            res = self._json("GET", path, "GETFILEBLOCKLOCATIONS",
                             offset=offset, length=length)
        except WebHdfsError as e:
            if e.status is not None and 400 <= e.status < 500:
                return []
            raise
        blocks = res.get("BlockLocations", {}).get("BlockLocation", [])
        return [{"offset": int(b.get("offset", 0)),
                 "length": int(b.get("length", 0)),
                 "hosts": list(b.get("hosts", []))} for b in blocks]


# -- per-namenode client cache ----------------------------------------------

_CLIENTS: Dict[str, WebHdfsClient] = {}


def hdfs_client(url: str) -> Tuple[WebHdfsClient, str]:
    """(the process's client for the url's namenode, the hdfs path)."""
    base, path = parse_hdfs_url(url)
    c = _CLIENTS.get(base)
    if c is None:
        c = _CLIENTS[base] = WebHdfsClient(base)
    return c, path


def _resolve(url: str, client: Optional[WebHdfsClient]
             ) -> Tuple[WebHdfsClient, str]:
    if client is not None:
        return client, parse_hdfs_url(url)[1]
    return hdfs_client(url)


def _read_exact(c: WebHdfsClient, path: str, off: int, ln: int,
                block: int = _RANGE_BLOCK) -> bytes:
    """Exactly ``ln`` bytes at ``off`` by bounded ranged reads (a server
    or proxy may clamp a requested length)."""
    out: List[bytes] = []
    while ln > 0:
        piece = c.open(path, offset=off, length=min(block, ln))
        if not piece:
            raise WebHdfsError(
                f"webhdfs read of {path!r} truncated at offset {off}")
        out.append(piece)
        off += len(piece)
        ln -= len(piece)
    return b"".join(out)


# -- the store layout on HDFS -----------------------------------------------


def hdfs_part_path(path: str, p: int) -> str:
    return path.rstrip("/") + f"/part-{p:05d}.bin"


def hdfs_store_meta(url: str, client: Optional[WebHdfsClient] = None
                    ) -> Dict[str, Any]:
    c, path = _resolve(url, client)
    return json.loads(c.read_all(path.rstrip("/") + "/meta.json"))


def _commit(c: WebHdfsClient, tmp: str, path: str,
            meta: Dict[str, Any]) -> None:
    """Write the manifest into the temp directory and rename it onto
    ``path`` (a reader never sees a half-written store)."""
    c.create(tmp + "/meta.json", json.dumps(meta, indent=1).encode())
    c.delete(path, recursive=True)   # False: nothing was there
    c.rename(tmp, path)


def hdfs_write_store(url: str, pd, partitioning=None, compression=None,
                     client: Optional[WebHdfsClient] = None) -> None:
    """``write_store`` for ``hdfs://`` paths: parts and manifest under
    ``<path>.tmp-<nonce>`` (parts uploaded in parallel), then the
    rename."""
    from dryad_tpu_torch.io.fnv import checksum_segments
    from dryad_tpu_torch.io.store import (_parallel, build_meta,
                                          pdata_part_segments,
                                          pdata_schema, segments_blob)

    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    c, path = _resolve(url, client)
    path = path.rstrip("/")
    schema = pdata_schema(pd)
    segments, counts = pdata_part_segments(pd, schema)
    tmp = path + ".tmp-" + uuid.uuid4().hex[:12]
    c.mkdirs(tmp)

    def upload(job):
        p, segs = job
        c.create(hdfs_part_path(tmp, p), segments_blob(segs, compression))
        return "%016x" % checksum_segments(segs)

    checksums = _parallel(upload, list(enumerate(segments)))
    _commit(c, tmp, path, build_meta(
        schema, counts, checksums, partitioning=partitioning,
        compression=compression, capacity=pd.capacity))


def _fill_ranged(c: WebHdfsClient, path: str, segs: List[np.ndarray],
                 block: int = _RANGE_BLOCK) -> None:
    """Fill preallocated segments with a part file's bytes by bounded
    ranged reads: the partition never exists as one host blob."""
    # memoryview.cast refuses zero-sized shapes; an empty segment needs
    # no bytes
    views = [memoryview(s).cast("B") for s in segs if s.nbytes]
    total = sum(len(v) for v in views)
    seg_i = seg_off = off = 0
    while off < total:
        piece = c.open(path, offset=off, length=min(block, total - off))
        if not piece:
            raise WebHdfsError(
                f"webhdfs read of {path!r} truncated at {off}/{total}")
        pv = memoryview(piece)
        while len(pv):
            take = min(len(views[seg_i]) - seg_off, len(pv))
            views[seg_i][seg_off:seg_off + take] = pv[:take]
            seg_off += take
            pv = pv[take:]
            if seg_off == len(views[seg_i]):
                seg_i += 1
                seg_off = 0
        off += len(piece)


def hdfs_read_part_views(url: str, meta: Dict[str, Any], p: int,
                         client: Optional[WebHdfsClient] = None):
    """(segments, column views) of one partition, as
    ``io/store._alloc_part`` lays them out: an uncompressed part fills
    its segments from ranged reads; a gzip part is fetched whole (ranges
    of a gzip stream do not decompress alone)."""
    from dryad_tpu_torch.io.store import _alloc_part, fill_segments

    c, path = _resolve(url, client)
    segs, cols = _alloc_part(meta["schema"], int(meta["counts"][p]))
    part = hdfs_part_path(path, p)
    if meta.get("compression") == "gzip":
        fill_segments(segs, gzip.decompress(c.read_all(part)),
                      f"hdfs part {part!r}")
    else:
        _fill_ranged(c, part, segs)
    return segs, cols


def _write_chunks_hdfs(url: str, chunks, schema: Dict[str, Any],
                       partitioning=None, compression=None,
                       client: Optional[WebHdfsClient] = None
                       ) -> Dict[str, Any]:
    """``ooc.write_chunks_to_store`` for ``hdfs://``: one part file per
    chunk, uploaded as it is drained (host memory O(chunk_rows)), the
    manifest last, then the rename.  Returns the manifest."""
    from dryad_tpu_torch.io.fnv import checksum_segments
    from dryad_tpu_torch.io.store import (build_meta, chunk_segments,
                                          segments_blob)

    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    c, path = _resolve(url, client)
    path = path.rstrip("/")
    tmp = path + ".tmp-" + uuid.uuid4().hex[:12]
    c.mkdirs(tmp)
    counts: List[int] = []
    checksums: List[str] = []
    for p, chunk in enumerate(chunks):
        segs = chunk_segments(schema, chunk.cols)
        checksums.append("%016x" % checksum_segments(segs))
        c.create(hdfs_part_path(tmp, p), segments_blob(segs, compression))
        counts.append(chunk.n)
    meta = build_meta(schema, counts, checksums,
                      partitioning=partitioning, compression=compression)
    _commit(c, tmp, path, meta)
    return meta


def hdfs_part_chunks(url: str, meta: Dict[str, Any], p: int,
                     chunk_rows: int,
                     client: Optional[WebHdfsClient] = None):
    """Yield one partition's rows as (column dict, n) chunks of at most
    ``chunk_rows`` rows, each fetched by one ranged read per column
    segment (rows [s, e) of a segment are one byte range), the segments
    of a chunk in parallel: host memory stays O(chunk_rows) even for a
    partition larger than host memory.  Each range goes through
    ``retry_transient``.  Uncompressed parts only; the checksums cover
    whole segments and are not verified on this path."""
    from dryad_tpu_torch.io.providers import retry_transient

    if meta.get("compression"):
        raise WebHdfsError(
            "hdfs_part_chunks streams uncompressed parts only")
    c, path = _resolve(url, client)
    schema = meta["schema"]
    cnt = int(meta["counts"][p])
    part = hdfs_part_path(path, p)
    # the segments in file order: sorted columns, a string column as
    # (data, lengths)
    layout = []   # (column, string part or None, dtype, row shape,
    #               row bytes, segment offset)
    base = 0
    for k in sorted(schema):
        spec = schema[k]
        if spec["kind"] == "str":
            pieces = [(0, np.dtype(np.uint8), (int(spec["max_len"]),)),
                      (1, np.dtype(np.int32), ())]
        else:
            pieces = [(None, np.dtype(spec["dtype"]),
                       tuple(int(d) for d in spec.get("shape", ())))]
        for str_part, dt, tail in pieces:
            rb = dt.itemsize * int(np.prod(tail, dtype=np.int64))
            layout.append((k, str_part, dt, tail, rb, base))
            base += cnt * rb

    def fetch(seg, s, e):
        _k, _sp, dt, tail, rb, off = seg
        raw = retry_transient(
            lambda: _read_exact(c, part, off + s * rb, (e - s) * rb),
            what=f"hdfs ranged read {part!r}", retries=2)
        # a writable copy: kernels downstream may write in place
        return np.frombuffer(bytearray(raw), dt).reshape((e - s,) + tail)

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, max(len(layout), 1))) as pool:
        for s in range(0, cnt, chunk_rows):
            e = min(s + chunk_rows, cnt)
            arrs = list(pool.map(lambda seg: fetch(seg, s, e), layout))
            cols: Dict[str, Any] = {}
            for (k, str_part, *_rest), arr in zip(layout, arrs):
                # a string's lengths follow its data
                cols[k] = (cols[k], arr) if str_part == 1 else arr
            yield cols, e - s


# -- block locality ----------------------------------------------------------


def hdfs_preferred_hosts(url: str, partitions: Sequence[int],
                         client: Optional[WebHdfsClient] = None
                         ) -> List[str]:
    """Hosts holding the given store partitions' blocks, most bytes
    first (ties by name); empty when the namenode has no block
    locations."""
    c, path = _resolve(url, client)
    parts = list(partitions)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, max(len(parts), 1))) as pool:
        per_part = list(pool.map(
            lambda p: c.block_locations(hdfs_part_path(path, p)), parts))
    weight: Dict[str, int] = {}
    for blocks in per_part:
        for bl in blocks:
            for h in bl["hosts"]:
                weight[h] = weight.get(h, 0) + max(int(bl["length"]), 1)
    return [h for h, _w in sorted(weight.items(),
                                  key=lambda kv: (-kv[1], kv[0]))]


# -- the text provider (ctx.read("hdfs://...")) ------------------------------


def hdfs_provider(ctx, rest: str, column: str = "line",
                  max_line_len: Optional[int] = None):
    """``ctx.read("hdfs://namenode:port/path")``: every file under a
    directory (sorted) is a text partition, a file path one partition;
    the bodies arrive by bounded ranged reads, in parallel."""
    from dryad_tpu_torch.io.providers import text_dataset_from_fetches

    url = "hdfs://" + rest
    c, path = hdfs_client(url)
    path = path.rstrip("/") or "/"
    st = c.status(path)
    if st.get("type") == "DIRECTORY":
        names = sorted(e["pathSuffix"] for e in c.list_status(path)
                       if e.get("type") == "FILE")
        if not names:
            raise FileNotFoundError(f"hdfs directory {url!r} has no files")
        base = "" if path == "/" else path
        paths = [base + "/" + n for n in names]
    else:
        paths = [path]
    return text_dataset_from_fetches(
        ctx, [lambda p=p: c.read_all(p) for p in paths],
        column, max_line_len)
