"""HTTP front end for the job-service daemon, plus the matching client —
the port of ``dryad_tpu/service/http.py``.

One small surface over the stdlib HTTP plumbing the repo already uses
(utils/viewer.serve_live, io/http_provider's test servers):

==========================  ==========================================
``GET /``                   live multi-job dashboard (HTML — the
                            obs/history index promoted with running
                            jobs + tenant shares, daemon.dashboard_html)
``GET /jobs``               all jobs, JSON rows
``GET /status/<job>``       one job's row (``?result=1`` inlines the
                            combined result when done)
``GET /tenants``            fair-share snapshot {tenant: [slot_s,
                            running, failures]}
``GET /slo``                per-tenant SLO attainment + error-budget
                            burn rate (obs/slo.py; tenants declare
                            objectives on their TenantQuota)
``GET /latency``            per-tenant tail latency: p50/p95/p99
                            submit->result, dominant-phase breakdown,
                            and the slowest-request exemplar (job +
                            trace id) per window (obs/latency.py)
``GET /events/<job>``       LONG-POLL the job's live event stream:
                            ``?after=N`` resumes at cursor N,
                            ``?timeout_s=S`` bounds the wait; returns
                            {"events", "next", "state",
                            "progress_pct"} the moment fresh records
                            exist (or immediately when the job is
                            terminal)
``GET /events/<job>/stream``  the same stream as Server-Sent Events
                            (``text/event-stream``): one ``data:``
                            frame per record from cursor ``?after=N``,
                            keepalive comments while idle, a final
                            ``event: done`` frame at the terminal
                            state — the Dryad GM web UI's live view,
                            multi-jobbed (per-job logs, so two
                            concurrent jobs' streams can never
                            interleave)
``GET /metrics``            Prometheus text exposition of the live
                            registry (per-job labeled families incl.)
``POST /submit``            JSON {app, params?, tenant?, priority?} ->
                            {"job": id}; typed DTA91x rejections come
                            back as JSON {"code", "error"} with a
                            matching status (below)
``POST /sql``               JSON {query, tenant?, priority?} ->
                            {"job": id}; the query compiles against
                            the daemon's catalog AT SUBMISSION — a
                            bad query is a typed DTA3xx rejection
                            (400) with every finding + line:column
                            span inlined as ``diagnostics``, zero
                            work started
``POST /cancel/<job>``      {"cancelled": bool}
==========================  ==========================================

A rejected submission maps its stable diagnostic code onto an HTTP
status so generic clients can react without parsing: DTA910 (unknown
app) -> 400, DTA911 (queue full — backpressure) -> 429, DTA912
(failure budget) -> 403, DTA913 (draining) -> 503, and every SQL
compile error DTA301-DTA306 -> 400 (so do pre-submit lint/cost
rejections like a DTA201 >HBM plan).  The Python client below
re-raises a typed :class:`ServiceRejected` carrying the daemon's
code/message, so local and remote submission surface identical errors.
"""

from __future__ import annotations

import http.server
import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from dryad_tpu_torch.service.tenancy import ServiceRejected

__all__ = ["serve", "REJECTION_STATUS", "Client"]

# stable diagnostic code -> HTTP status (docs/service.md table).  The
# SQL front end's compile errors (dryad_tpu_torch/sql, DTA301-306) are all
# client errors: the query text itself is wrong.
REJECTION_STATUS = {"DTA910": 400, "DTA911": 429, "DTA912": 403,
                    "DTA913": 503,
                    "DTA301": 400, "DTA302": 400, "DTA303": 400,
                    "DTA304": 400, "DTA305": 400, "DTA306": 400,
                    "DTA307": 400}


def _compile_rejection(e: Exception):
    """(status, body) for non-admission rejections raised by a
    submission: SQL compile errors (sql.SqlError — DTA3xx, every
    finding inlined) and pre-submit lint gates (analysis.LintError,
    e.g. a DTA201 provably->HBM plan) are the CLIENT's fault -> 400
    with the stable code; anything else is a 500."""
    report = getattr(e, "report", None)   # SqlError / LintError only
    if report is not None and getattr(report, "errors", None):
        code = getattr(e, "code", None) or report.errors[0].code
        return (REJECTION_STATUS.get(code, 400),
                {"error": str(e), "code": code,
                 "diagnostics": [d.render() for d in report]})
    return 500, {"error": repr(e)}


def serve(service, port: int = 0, host: str = "127.0.0.1"):
    """Bind the front end for ``service`` (a JobService); returns
    ``(server, port)`` — call ``server.serve_forever()`` (the CLI does)
    or drive it from a thread (tests do)."""

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):      # the service log is the log
            pass

        def _send(self, status: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, obj: Any) -> None:
            self._send(status, json.dumps(obj, default=str).encode())

        def _qs(self, query: str) -> Dict[str, str]:
            import urllib.parse
            return {k: v[-1] for k, v
                    in urllib.parse.parse_qs(query).items()}

        def _sse(self, job, after: int) -> None:
            """Server-Sent Events: stream the job's records from the
            cursor, keepalive comments while idle, one final ``event:
            done`` frame once the job is terminal and fully drained
            (``log.closed`` guarantees the close-time ``job_archived``
            record has landed).  A vanished client just ends the
            stream — it holds no job state."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            n = after
            try:
                while True:
                    evs, n = job.events_since(n, timeout=0.5)
                    for e in evs:
                        self.wfile.write(
                            b"data: "
                            + json.dumps(e, default=str).encode()
                            + b"\n\n")
                    if not evs and job.state not in ("queued",
                                                     "running") \
                            and job.log.closed:
                        self.wfile.write(
                            b"event: done\ndata: "
                            + json.dumps({"state": job.state,
                                          "next": n}).encode()
                            + b"\n\n")
                        self.wfile.flush()
                        return
                    if not evs:
                        self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                return

        def do_GET(self):
            path, _, query = self.path.partition("?")
            try:
                if path == "/":
                    self._send(200, service.dashboard_html().encode(),
                               "text/html; charset=utf-8")
                elif path == "/jobs":
                    self._json(200, service.list_jobs())
                elif path == "/tenants":
                    self._json(200, service.admission.shares())
                elif path == "/slo":
                    self._json(200, service.slo_snapshot())
                elif path == "/latency":
                    self._json(200, service.latency_snapshot())
                elif path == "/standing":
                    self._json(200, service.standing_rows())
                elif path.startswith("/events/"):
                    rest = path[len("/events/"):]
                    sse = rest.endswith("/stream")
                    jid = rest[:-len("/stream")] if sse else rest
                    try:
                        job = service.job(jid)
                    except KeyError:
                        return self._json(
                            404, {"error": f"unknown job {jid}"})
                    qs = self._qs(query)
                    after = max(0, int(qs.get("after", 0)))
                    if sse:
                        return self._sse(job, after)
                    timeout = min(30.0,
                                  float(qs.get("timeout_s", 10.0)))
                    evs, nxt = job.events_since(after, timeout=timeout)
                    self._json(200, {"job": job.id, "state": job.state,
                                     "progress_pct": job.progress_pct,
                                     "events": evs, "next": nxt})
                elif path == "/metrics":
                    self._send(200, service.metrics_text().encode(),
                               "text/plain; version=0.0.4; "
                               "charset=utf-8")
                elif path.startswith("/status/"):
                    jid = path[len("/status/"):]
                    with_result = "result=1" in query
                    try:
                        self._json(200, service.status(
                            jid, with_result=with_result))
                    except KeyError:
                        self._json(404, {"error": f"unknown job {jid}"})
                else:
                    self._json(404, {"error": f"no route {path}"})
            except Exception as e:      # surface, never kill the server
                self._json(500, {"error": repr(e)})

        def do_POST(self):
            path = self.path.partition("?")[0]
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            try:
                body = json.loads(raw.decode() or "{}")
            except ValueError:
                return self._json(400, {"error": "malformed JSON body",
                                        "code": "DTA910"})
            try:
                if path == "/submit":
                    jid = service.submit(
                        body.get("app", ""),
                        params=body.get("params") or {},
                        tenant=str(body.get("tenant", "default")),
                        priority=int(body.get("priority", 0)))
                    self._json(200, {"job": jid})
                elif path == "/sql":
                    jid = service.submit_sql(
                        str(body.get("query", "")),
                        tenant=str(body.get("tenant", "default")),
                        priority=int(body.get("priority", 0)))
                    out = {"job": jid}
                    standing = getattr(service, "standing", None)
                    if (standing is not None
                            and standing.get(jid) is not None):
                        # EMIT EVERY registered a standing query: the
                        # id follows the SAME status/events/stream/
                        # cancel routes as a job id
                        out["standing"] = True
                    self._json(200, out)
                elif path.startswith("/cancel/"):
                    jid = path[len("/cancel/"):]
                    try:
                        self._json(200,
                                   {"cancelled": service.cancel(jid)})
                    except KeyError:
                        self._json(404, {"error": f"unknown job {jid}"})
                else:
                    self._json(404, {"error": f"no route {path}"})
            except ServiceRejected as e:
                self._json(REJECTION_STATUS.get(e.code, 400),
                           {"error": str(e), "code": e.code,
                            "tenant": e.tenant})
            except Exception as e:
                status, obj = _compile_rejection(e)
                self._json(status, obj)

    srv = http.server.ThreadingHTTPServer((host, port), H)
    return srv, srv.server_address[1]


class Client:
    """Thin urllib client for the front end (the CLI's transport; tests
    use it too).  Typed rejections re-raise as :class:`ServiceRejected`
    carrying the daemon's code/message."""

    def __init__(self, url: str, timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _req(self, path: str, body: Optional[dict] = None) -> Any:
        data = (json.dumps(body).encode() if body is not None else None)
        req = urllib.request.Request(
            self.url + path, data=data,
            headers={"Content-Type": "application/json"} if data else {},
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                payload = r.read()
        except urllib.error.HTTPError as e:
            payload = e.read()
            try:
                obj = json.loads(payload.decode())
            except ValueError:
                raise RuntimeError(f"service error {e.code}: "
                                   f"{payload[:200]!r}")
            code = obj.get("code")
            if code:
                # ANY code-carrying error body is a typed rejection —
                # admission walls (DTA91x), SQL compile errors
                # (DTA3xx), AND pre-submit lint/cost gates (e.g. a
                # DTA201 >HBM plan) — so local and remote submission
                # raise the same exception type
                msg = obj.get("error", code)
                # the daemon's message already carries the "[CODE] "
                # prefix DiagnosticError adds — re-wrapping would
                # stutter it
                if msg.startswith(f"[{code}] "):
                    msg = msg[len(code) + 3:]
                raise ServiceRejected(msg, code=code,
                                      tenant=obj.get("tenant", ""))
            raise RuntimeError(obj.get("error", f"HTTP {e.code}"))
        return json.loads(payload.decode())

    def submit(self, app: str, params: Optional[dict] = None,
               tenant: str = "default", priority: int = 0) -> str:
        return self._req("/submit", {"app": app, "params": params or {},
                                     "tenant": tenant,
                                     "priority": priority})["job"]

    def submit_sql(self, query: str, tenant: str = "default",
                   priority: int = 0) -> str:
        """Submit a SQL query over the daemon's catalog.  A compile
        error re-raises as ServiceRejected with its DTA3xx code and
        the full line:column diagnostics in the message."""
        return self._req("/sql", {"query": query, "tenant": tenant,
                                  "priority": priority})["job"]

    def status(self, job: str, result: bool = False) -> Dict[str, Any]:
        return self._req(f"/status/{job}"
                         + ("?result=1" if result else ""))

    def cancel(self, job: str) -> bool:
        return bool(self._req(f"/cancel/{job}", {})["cancelled"])

    def jobs(self) -> List[Dict[str, Any]]:
        return self._req("/jobs")

    def tenants(self) -> Dict[str, Any]:
        return self._req("/tenants")

    def slo(self) -> Dict[str, Any]:
        """Per-tenant SLO attainment/burn snapshot (``GET /slo``)."""
        return self._req("/slo")

    def latency(self) -> Dict[str, Any]:
        """Per-tenant tail-latency snapshot: percentiles + dominant
        phase + slowest-request exemplar (``GET /latency``)."""
        return self._req("/latency")

    def standing(self) -> List[Dict[str, Any]]:
        """Status rows of every registered standing query
        (``GET /standing``)."""
        return self._req("/standing")

    def events(self, job: str, after: int = 0,
               timeout_s: float = 10.0) -> Dict[str, Any]:
        """One long-poll read of the job's live event stream: returns
        {"events", "next", "state", "progress_pct"}; pass the returned
        ``next`` as the next call's ``after`` to follow the job."""
        return self._req(f"/events/{job}?after={after}"
                         f"&timeout_s={timeout_s}")

    def stream_events(self, job: str, after: int = 0):
        """Generator over the job's SSE stream
        (``GET /events/<job>/stream``): yields each recorded event dict
        live, returning after the terminal ``done`` frame."""
        req = urllib.request.Request(
            self.url + f"/events/{job}/stream?after={after}")
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as e:
            # same clean-failure contract as _req: an unknown job is a
            # typed RuntimeError ("unknown job ..."), not a raw
            # HTTPError traceback out of the CLI
            payload = e.read()
            try:
                obj = json.loads(payload.decode())
            except ValueError:
                obj = {}
            raise RuntimeError(obj.get("error",
                                       f"service error {e.code}"))
        with resp as r:
            done = False
            for raw in r:
                line = raw.decode("utf-8", "replace").rstrip("\n")
                if line == "event: done":
                    done = True
                elif line.startswith("data: "):
                    if done:
                        return      # the terminal frame's payload
                    yield json.loads(line[len("data: "):])

    def metrics(self) -> str:
        req = urllib.request.Request(self.url + "/metrics")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.read().decode()

    def wait(self, job: str, timeout: float = 300.0,
             poll_s: float = 0.25) -> Dict[str, Any]:
        """Poll until the job reaches a terminal state (or timeout);
        returns the final row with the result inlined."""
        t0 = time.time()
        while True:
            row = self.status(job, result=True)
            if row["state"] in ("done", "failed", "cancelled"):
                return row
            if time.time() - t0 > timeout:
                return row
            time.sleep(poll_s)
