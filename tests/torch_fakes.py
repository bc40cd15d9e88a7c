"""Loopback test doubles of remote stores for the port: an S3-compatible
server that verifies every request's SigV4 signature, and a static HTTP
server with range support and a partition listing.  They import neither
jax nor dryad_tpu, so ``chip_smoke.py`` and the port's tests both use
them.  Both listen on 127.0.0.1 only; their byte rates measure loopback,
not a network.

    with FakeS3() as s3:          # s3.endpoint, s3.client(), s3.objects
        ...
    with RangeServer(files) as web:    # web.base ("127.0.0.1:port")
        ...
"""

from __future__ import annotations

import datetime
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from dryad_tpu_torch.io.s3 import S3Client, S3Config, sign_v4

__all__ = ["FakeS3", "RangeServer", "ACCESS", "SECRET"]

ACCESS, SECRET = "AKIDTEST", "s3cr3t-key"


class _Server:
    """A ThreadingHTTPServer on a free loopback port, served on a daemon
    thread until ``close``."""

    def __init__(self, handler):
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FakeS3(_Server):
    """An in-memory S3 endpoint.  Every request's Authorization is
    recomputed with ``sign_v4`` from the request as received and
    refused (403) when it differs; ``bad_auth`` lists the refusals.
    ``fail_next[bucket/key] = n`` serves n 500s to GETs of that key;
    ListObjectsV2 pages hold ``page`` keys, so listings paginate; a
    multipart upload is assembled from its parts."""

    def __init__(self, page: int = 2):
        self.objects: Dict[str, bytes] = {}
        self.uploads: Dict[str, Dict[int, bytes]] = {}
        self.fail_next: Dict[str, int] = {}
        self.bad_auth: List[Tuple[str, str]] = []
        self.requests: List[Tuple[str, str]] = []
        self._lock = threading.Lock()
        fake = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _check_auth(self, body: bytes) -> bool:
                with fake._lock:
                    fake.requests.append((self.command, self.path))
                auth = self.headers.get("Authorization", "")
                if f"Credential={ACCESS}/" not in auth:
                    fake.bad_auth.append(("missing-cred", self.path))
                    return False
                cfg = S3Config(endpoint_url="http://" + self.headers["Host"],
                               region="us-east-1", access_key=ACCESS,
                               secret_key=SECRET)
                now = datetime.datetime.strptime(
                    self.headers["x-amz-date"], "%Y%m%dT%H%M%SZ").replace(
                    tzinfo=datetime.timezone.utc)
                url = "http://" + self.headers["Host"] + self.path
                extra = {}
                if self.headers.get("Range"):
                    extra["Range"] = self.headers["Range"]
                want = sign_v4(cfg, self.command, url, extra, body, now=now)
                if want["Authorization"] != auth:
                    fake.bad_auth.append(("sig-mismatch", self.path))
                    return False
                return True

            def _reply(self, status, body=b"", headers=()):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                return self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))

            def _key(self):
                return urllib.parse.unquote(
                    self.path.split("?")[0].lstrip("/"))

            def do_PUT(self):
                body = self._body()
                if not self._check_auth(body):
                    return self._reply(403)
                q = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query)
                key = self._key()
                with fake._lock:
                    if "partNumber" in q:
                        n = q["partNumber"][0]
                        fake.uploads[q["uploadId"][0]][int(n)] = body
                        etag = f'"p{n}"'
                    else:
                        fake.objects[key] = body
                        etag = '"x"'
                self._reply(200, headers=[("ETag", etag)])

            def do_POST(self):
                body = self._body()
                if not self._check_auth(body):
                    return self._reply(403)
                q = urllib.parse.urlsplit(self.path).query
                qs = urllib.parse.parse_qs(q, keep_blank_values=True)
                key = self._key()
                with fake._lock:
                    if "uploads" in qs or q == "uploads":
                        uid = f"up-{len(fake.uploads)}"
                        fake.uploads[uid] = {}
                        return self._reply(200, (
                            f"<InitiateMultipartUploadResult><UploadId>"
                            f"{uid}</UploadId>"
                            f"</InitiateMultipartUploadResult>").encode())
                    if "uploadId" in qs:
                        up = fake.uploads[qs["uploadId"][0]]
                        fake.objects[key] = b"".join(up[i]
                                                     for i in sorted(up))
                        return self._reply(
                            200, b"<CompleteMultipartUploadResult/>")
                self._reply(400)

            def do_GET(self):
                if not self._check_auth(b""):
                    return self._reply(403)
                parts = urllib.parse.urlsplit(self.path)
                qs = urllib.parse.parse_qs(parts.query,
                                           keep_blank_values=True)
                if "list-type" in qs:
                    bucket = parts.path.lstrip("/").split("/")[0]
                    pfx = f"{bucket}/{qs.get('prefix', [''])[0]}"
                    with fake._lock:
                        keys = sorted(k for k in fake.objects
                                      if k.startswith(pfx))
                        sizes = {k: len(fake.objects[k]) for k in keys}
                    tok = qs.get("continuation-token", [None])[0]
                    start = int(tok) if tok else 0
                    pg = keys[start:start + page]
                    truncated = start + page < len(keys)
                    items = "".join(
                        f"<Contents><Key>{k.split('/', 1)[1]}</Key>"
                        f"<Size>{sizes[k]}</Size></Contents>" for k in pg)
                    nxt = (f"<NextContinuationToken>{start + page}"
                           f"</NextContinuationToken>" if truncated
                           else "")
                    return self._reply(200, (
                        f"<ListBucketResult><IsTruncated>"
                        f"{'true' if truncated else 'false'}"
                        f"</IsTruncated>{nxt}{items}"
                        f"</ListBucketResult>").encode())
                key = self._key()
                with fake._lock:
                    if fake.fail_next.get(key, 0) > 0:
                        fake.fail_next[key] -= 1
                        fail = True
                    else:
                        fail = False
                    body = fake.objects.get(key)
                if fail:
                    return self._reply(500, b"try again")
                if body is None:
                    return self._reply(404, b"<Error>NoSuchKey</Error>")
                rng = self.headers.get("Range")
                if rng:
                    lo, hi = rng.split("=")[1].split("-")
                    return self._reply(206, body[int(lo):int(hi) + 1])
                self._reply(200, body)

            def do_HEAD(self):
                if not self._check_auth(b""):
                    return self._reply(403)
                body = fake.objects.get(self._key())
                if body is None:
                    return self._reply(404)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()

            def do_DELETE(self):
                if not self._check_auth(b""):
                    return self._reply(403)
                with fake._lock:
                    fake.objects.pop(self._key(), None)
                self._reply(204)

        super().__init__(_Handler)
        self.endpoint = f"http://127.0.0.1:{self.port}"

    def config(self, **kw) -> S3Config:
        """A config of this endpoint with the fake's credentials."""
        return S3Config(endpoint_url=self.endpoint, region="us-east-1",
                        access_key=ACCESS, secret_key=SECRET, **kw)

    def client(self, **kw) -> S3Client:
        return S3Client(self.config(**kw))

    def environ(self) -> Dict[str, str]:
        """The ``AWS_*`` variables that point the default client here."""
        return {"AWS_ENDPOINT_URL": self.endpoint,
                "AWS_ACCESS_KEY_ID": ACCESS,
                "AWS_SECRET_ACCESS_KEY": SECRET,
                "AWS_REGION": "us-east-1"}


class RangeServer(_Server):
    """Static files over HTTP with ``Range`` support: GET ``/<name>``
    serves a file (206 for a ranged request), GET ``/`` lists the names,
    HEAD advertises ``Accept-Ranges: bytes``.  ``requests`` records each
    GET as (path, Range header or None)."""

    def __init__(self, files: Dict[str, bytes]):
        self.files = dict(files)
        self.requests: List[Tuple[str, Optional[str]]] = []
        web = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _body_for(self):
                path = self.path.lstrip("/")
                if path == "" or path.endswith("/"):
                    return "\n".join(sorted(web.files)).encode(), True
                return web.files.get(path), False

            def do_HEAD(self):
                body, _ = self._body_for()
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                body, listing = self._body_for()
                if body is None:
                    self.send_error(404)
                    return
                rng = self.headers.get("Range")
                web.requests.append((self.path, rng))
                if rng and not listing:
                    lo, hi = (int(x) for x in rng.split("=")[1].split("-"))
                    part = body[lo:hi + 1]
                    self.send_response(206)
                    self.send_header("Content-Range",
                                     f"bytes {lo}-{hi}/{len(body)}")
                    self.send_header("Content-Length", str(len(part)))
                    self.end_headers()
                    self.wfile.write(part)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        super().__init__(_Handler)
        self.base = f"127.0.0.1:{self.port}"
