"""HTTP range-reading data provider — the port of
``dryad_tpu/io/http_provider.py``.

``ctx.read("http://host/path")`` fetches a body with block-ranged GETs
(the standard ``Range`` header; one whole-body GET when the server does
not advertise ranges), and a URL ending in ``/`` lists its partition
files as newline-separated relative names, one text partition each.
Every request carries a timeout, so a stalled server fails the read with
an ``IOError`` naming the URL.  Each fetch is one ``http.get`` io span
(bytes and ranged requests).
"""

from __future__ import annotations

import contextlib
import socket
import urllib.error
import urllib.request
from typing import Iterator, List, Optional, Tuple

__all__ = ["read_url_bytes", "iter_url_blocks", "enumerate_http",
           "http_provider", "HTTP_TIMEOUT_S"]

_DEFAULT_BLOCK = 2 << 20   # bytes per ranged GET
HTTP_TIMEOUT_S = 60.0


@contextlib.contextmanager
def _open(req, timeout: float):
    """urlopen with a timeout over both the connect and the body read;
    a socket timeout surfaces as an IOError naming the URL."""
    url = req.full_url if hasattr(req, "full_url") else req
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            yield r
    except (socket.timeout, TimeoutError) as e:
        raise IOError(f"HTTP request timed out after {timeout}s: {url}") \
            from e
    except urllib.error.URLError as e:
        if isinstance(getattr(e, "reason", None),
                      (socket.timeout, TimeoutError)):
            raise IOError(
                f"HTTP request timed out after {timeout}s: {url}") from e
        raise


def _head(url: str, timeout: float = HTTP_TIMEOUT_S) -> Tuple[int, bool]:
    """(content length, range support); a server that refuses HEAD gets
    the whole-body GET."""
    req = urllib.request.Request(url, method="HEAD")
    try:
        with _open(req, timeout) as r:
            size = int(r.headers.get("Content-Length", -1))
            ranges = r.headers.get("Accept-Ranges", "") == "bytes"
    except (urllib.error.HTTPError, urllib.error.URLError):
        return -1, False
    return size, ranges


def iter_url_blocks(url: str, block: int = _DEFAULT_BLOCK,
                    timeout: float = HTTP_TIMEOUT_S,
                    stats: Optional[dict] = None) -> Iterator[bytes]:
    """A URL's body in order by block-ranged GETs (the whole body at
    once from a server without range support); ``stats["requests"]``
    counts the GETs."""
    stats = {} if stats is None else stats
    stats["requests"] = 0
    size, ranges = _head(url, timeout)
    if not ranges or size < 0:
        with _open(urllib.request.Request(url), timeout) as r:
            body = r.read()
        stats["requests"] = 1
        yield body
        return
    off = 0
    while off < size:
        end = min(off + block, size) - 1
        req = urllib.request.Request(
            url, headers={"Range": f"bytes={off}-{end}"})
        stats["requests"] += 1
        with _open(req, timeout) as r:
            body = r.read()
            if r.status != 206:
                # ranges advertised, the whole body served: looping on
                # would repeat it
                yield body[off:]
                return
            if not body:
                raise IOError(
                    f"empty 206 response for {url} range {off}-{end}")
        yield body
        # advance by what arrived: a proxy may clamp the range
        off += len(body)


def read_url_bytes(url: str, block: int = _DEFAULT_BLOCK,
                   timeout: float = HTTP_TIMEOUT_S) -> bytes:
    """A URL's body by block-ranged GETs (one whole-body GET without
    range support); one ``http.get`` io span (bytes, requests)."""
    from dryad_tpu_torch.obs import trace
    with trace.span("http.get", "io", url=url) as sp:
        stats: dict = {}
        body = b"".join(iter_url_blocks(url, block, timeout, stats))
        sp.set(bytes=len(body), requests=stats["requests"])
        return body


def enumerate_http(url: str,
                   timeout: float = HTTP_TIMEOUT_S) -> List[str]:
    """A URL ending in ``/`` -> its partition files (the listing's
    newline-separated relative names); any other URL -> itself."""
    if not url.endswith("/"):
        return [url]
    with _open(urllib.request.Request(url), timeout) as r:
        body = r.read().decode()
    names = [ln.strip() for ln in body.splitlines() if ln.strip()]
    if not names:
        raise FileNotFoundError(f"http listing {url!r} names no files")
    return [url + n for n in names]


def http_provider(ctx, rest: str, column: str = "line",
                  max_line_len: Optional[int] = None,
                  block: int = _DEFAULT_BLOCK):
    """``ctx.read("http://host/path")``: a trailing ``/`` enumerates the
    partition files; the bodies arrive by ranged GETs, the partitions
    fetched in parallel."""
    from dryad_tpu_torch.io.providers import text_dataset_from_fetches

    urls = enumerate_http("http://" + rest)
    return text_dataset_from_fetches(
        ctx, [lambda u=u: read_url_bytes(u, block=block) for u in urls],
        column, max_line_len)
