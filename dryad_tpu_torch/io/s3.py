"""S3-compatible object-store client — the port of ``dryad_tpu/io/s3.py``.

It speaks the S3 REST dialect (AWS, GCS's interoperable endpoint, MinIO
and test fakes serve it) with the standard library alone:

* AWS Signature Version 4 request signing;
* bounded exponential-backoff retries on 5xx and connection errors (a
  4xx raises at once);
* ranged GETs;
* multipart uploads of bodies past ``S3Config.multipart_bytes``;
* ListObjectsV2 with continuation-token pagination.

Credentials and the endpoint come from the arguments or the standard
environment (``AWS_ACCESS_KEY_ID``, ``AWS_SECRET_ACCESS_KEY``,
``AWS_REGION``, ``AWS_ENDPOINT_URL``).  ``io/s3_store.py`` lays the
partitioned store out on top; ``io/providers.py`` registers ``s3://``
for ``Context.read``.  Every GET and PUT is one io span (``s3.get``,
``s3.put``).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["S3Config", "S3Client", "S3Error", "parse_s3_url", "sign_v4"]

_ALGO = "AWS4-HMAC-SHA256"
# the first retry's wait in seconds (it doubles per retry, up to 2 s)
BACKOFF_S = 0.1


class S3Error(IOError):
    """A non-retryable S3 failure (4xx, or retries exhausted)."""

    def __init__(self, msg: str, status: Optional[int] = None):
        super().__init__(msg)
        self.status = status


def parse_s3_url(url: str) -> Tuple[str, str]:
    """s3://bucket/key -> (bucket, key)."""
    if not url.startswith("s3://"):
        raise ValueError(f"not an s3 url: {url!r}")
    bucket, _, key = url[5:].partition("/")
    if not bucket:
        raise ValueError(f"s3 url has no bucket: {url!r}")
    return bucket, key


class S3Config:
    """Connection, credential and retry settings (environment-resolved
    defaults)."""

    def __init__(self, endpoint_url: Optional[str] = None,
                 region: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 max_retries: int = 4,
                 timeout_s: float = 60.0,
                 multipart_bytes: int = 64 << 20):
        env = os.environ
        self.endpoint_url = (endpoint_url or env.get("AWS_ENDPOINT_URL")
                             or "https://s3.amazonaws.com")
        self.region = region or env.get("AWS_REGION") or "us-east-1"
        self.access_key = access_key or env.get("AWS_ACCESS_KEY_ID") or ""
        self.secret_key = (secret_key or env.get("AWS_SECRET_ACCESS_KEY")
                           or "")
        self.max_retries = max_retries
        self.timeout_s = timeout_s
        self.multipart_bytes = multipart_bytes


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _orig(headers: Dict[str, str], lower: str) -> str:
    for k in headers:
        if k.lower() == lower:
            return k
    raise KeyError(lower)


def sign_v4(cfg: S3Config, method: str, url: str,
            headers: Dict[str, str], payload: bytes,
            now: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """AWS Signature Version 4 of one request: the headers to send (the
    given ones plus host, x-amz-date, x-amz-content-sha256 and
    Authorization).  Deterministic given ``now``.

    The canonical URI is the URL's path as it goes on the wire: the key
    is percent-encoded once when the URL is built, and encoding it again
    here would sign ``%2520`` for a space."""
    parts = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()

    out = dict(headers)
    out["host"] = parts.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    canonical_uri = parts.path or "/"
    q = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}="
        f"{urllib.parse.quote(v, safe='')}"
        for k, v in sorted(q))
    signed_names = sorted(k.lower() for k in out)
    canonical_headers = "".join(
        f"{k}:{out[_orig(out, k)].strip()}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    creq = "\n".join([method, canonical_uri, canonical_query,
                      canonical_headers, signed_headers, payload_hash])

    scope = f"{datestamp}/{cfg.region}/s3/aws4_request"
    to_sign = "\n".join([_ALGO, amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
    k = _hmac(("AWS4" + cfg.secret_key).encode(), datestamp)
    k = _hmac(k, cfg.region)
    k = _hmac(k, "s3")
    k = _hmac(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"{_ALGO} Credential={cfg.access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={sig}")
    return out


class S3Client:
    """A minimal authenticated S3 REST client with bounded retries."""

    def __init__(self, config: Optional[S3Config] = None):
        self.cfg = config or S3Config()

    # -- plumbing ----------------------------------------------------------

    def _url(self, bucket: str, key: str, query: str = "") -> str:
        base = self.cfg.endpoint_url.rstrip("/")
        path = (f"/{bucket}/{urllib.parse.quote(key)}" if key
                else f"/{bucket}")
        return base + path + (f"?{query}" if query else "")

    def _request(self, method: str, url: str, payload: bytes = b"",
                 headers: Optional[Dict[str, str]] = None,
                 ok: Tuple[int, ...] = (200,)) -> Tuple[int, Dict, bytes]:
        """One signed request, retried with exponential backoff on 5xx
        and connection errors; a 4xx raises S3Error at once."""
        last: Optional[BaseException] = None
        for attempt in range(self.cfg.max_retries + 1):
            signed = sign_v4(self.cfg, method, url, dict(headers or {}),
                             payload)
            req = urllib.request.Request(url, data=payload or None,
                                         headers=signed, method=method)
            try:
                with urllib.request.urlopen(
                        req, timeout=self.cfg.timeout_s) as r:
                    body = r.read()
                    if r.status in ok:
                        return r.status, dict(r.headers), body
                    last = S3Error(f"{method} {url}: HTTP {r.status}",
                                   r.status)
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    raise S3Error(
                        f"{method} {url}: HTTP {e.code}: "
                        f"{e.read()[:300].decode(errors='replace')}",
                        e.code) from e
                last = e
            except (urllib.error.URLError, socket.timeout, OSError) as e:
                last = e
            if attempt < self.cfg.max_retries:
                time.sleep(min(BACKOFF_S * (2 ** attempt), 2.0))
        raise S3Error(f"{method} {url}: retries exhausted: {last!r}")

    # -- object operations -------------------------------------------------

    def get_object(self, bucket: str, key: str,
                   rng: Optional[Tuple[int, int]] = None) -> bytes:
        """An object's bytes (or bytes [start, end], inclusive)."""
        from dryad_tpu_torch.obs import trace
        headers = {}
        ok: Tuple[int, ...] = (200,)
        if rng is not None:
            headers["Range"] = f"bytes={rng[0]}-{rng[1]}"
            ok = (200, 206)
        with trace.span("s3.get", "io", key=f"s3://{bucket}/{key}",
                        **({"offset": rng[0]} if rng else {})) as sp:
            _, _, body = self._request("GET", self._url(bucket, key),
                                       headers=headers, ok=ok)
            sp.set(bytes=len(body))
        return body

    def head_size(self, bucket: str, key: str) -> int:
        _, headers, _ = self._request("HEAD", self._url(bucket, key))
        return int(headers.get("Content-Length", -1))

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        """Upload; a body over ``multipart_bytes`` goes through the
        multipart protocol."""
        from dryad_tpu_torch.obs import trace
        with trace.span("s3.put", "io", key=f"s3://{bucket}/{key}",
                        bytes=len(data)):
            if len(data) <= self.cfg.multipart_bytes:
                self._request("PUT", self._url(bucket, key), payload=data)
                return
            self._multipart_put(bucket, key, data)

    def _multipart_put(self, bucket: str, key: str, data: bytes) -> None:
        _, _, body = self._request(
            "POST", self._url(bucket, key, "uploads"), ok=(200,))
        root = ET.fromstring(body)
        upload_id = (root.findtext(".//{*}UploadId")
                     or root.findtext(".//UploadId"))
        if not upload_id:
            raise S3Error(f"multipart initiate returned no UploadId for "
                          f"s3://{bucket}/{key}")
        etags: List[str] = []
        part_size = self.cfg.multipart_bytes
        for i, off in enumerate(range(0, len(data), part_size), start=1):
            _, headers, _ = self._request(
                "PUT",
                self._url(bucket, key,
                          f"partNumber={i}&uploadId={upload_id}"),
                payload=data[off:off + part_size])
            etags.append(headers.get("ETag", f'"{i}"'))
        complete = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
            for i, e in enumerate(etags, start=1)) + \
            "</CompleteMultipartUpload>"
        self._request("POST",
                      self._url(bucket, key, f"uploadId={upload_id}"),
                      payload=complete.encode())

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("DELETE", self._url(bucket, key), ok=(200, 204))

    def list_objects(self, bucket: str, prefix: str = ""
                     ) -> Iterator[Tuple[str, int]]:
        """Every (key, size) under ``prefix``, page by page
        (ListObjectsV2 continuation tokens)."""
        token: Optional[str] = None
        while True:
            q = ("list-type=2&prefix="
                 + urllib.parse.quote(prefix, safe=""))
            if token:
                q += ("&continuation-token="
                      + urllib.parse.quote(token, safe=""))
            _, _, body = self._request("GET", self._url(bucket, "", q))
            root = ET.fromstring(body)

            def txt(el, name):
                v = el.findtext(f"{{*}}{name}")
                return v if v is not None else el.findtext(name)

            for c in list(root.iter()):
                if c.tag.endswith("Contents"):
                    yield txt(c, "Key"), int(txt(c, "Size") or 0)
            truncated = (txt(root, "IsTruncated") or "false") == "true"
            token = txt(root, "NextContinuationToken")
            if not truncated or not token:
                return
