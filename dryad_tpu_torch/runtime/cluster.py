"""Driver-side cluster control plane: spawn workers, submit gang jobs,
detect process failure, restart — the port of
``dryad_tpu/runtime/cluster.py``.

The counterpart of the reference's LocalJobSubmission
(LinqToDryad/LocalJobSubmission.cs:97-302 — real GM + real worker
processes on one box, its default test topology) plus the GM's
process-failure reaction (DrVertex ReactToFailedVertex).  Each worker is
``python -m dryad_tpu_torch.runtime.worker`` on its own device (the CUDA
card unless the caller passes ``device="cpu"``), holding
``devices_per_process`` logical partitions there; several workers share
one card, each with its own CUDA context.  Workers are spawned as fresh
interpreters (never forked from a process that holds a CUDA context),
with the control-plane secret in their environment.

Farm tasks (``runtime/farm.py``, the job service's cluster fleet) run a
whole plan on one worker.  A gang SPMD job (``execute``) runs one plan
on every gang worker at once (``runtime/exec_common.py``), the
``nparts = n_processes x devices_per_process`` partitions spread over
them and the exchanges crossing processes through a gloo process group
the workers join at start (rendezvous on a free port of this host).  A
dead worker or an error reply tears the whole gang down (SPMD stages are
gang-scheduled: one lost process stalls every collective); the next job
restarts it, and the driver replays a job lost to a dead or wedged
worker once (its sources are re-readable: the lineage argument).  The
straggler / wedge watchdog (``_gather_job_replies``) reads the workers'
heartbeats.
"""

from __future__ import annotations

import os
import select
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

from dryad_tpu_torch.runtime import protocol
from dryad_tpu_torch.runtime.interfaces import ClusterBackend

__all__ = ["LocalCluster", "WorkerFailure", "ClusterJobError",
           "package_env"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def package_env() -> Dict[str, str]:
    """The environment of a ``python -m dryad_tpu_torch...`` child (a
    worker, the chaos victim): ours, with PYTHONPATH this package's root,
    then ours, then our cwd.  ``-m`` would put the child's cwd ahead of
    them all, and a cwd holding another ``dryad_tpu_torch`` would give the
    child other code than ours: PYTHONSAFEPATH keeps it off, and the cwd
    stays importable after the package (an fn module there)."""
    import dryad_tpu_torch
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(dryad_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        + [os.getcwd()])
    env["PYTHONSAFEPATH"] = "1"
    return env


class WorkerFailure(RuntimeError):
    """A worker process died or stopped responding."""


class ClusterJobError(RuntimeError):
    """A job raised on a worker (plan/UDF/capacity error).
    ``missing_token`` carries a lost cluster-resident token when that is
    the cause (structured, from the worker's reply: the driver's healing
    reads this attribute, never the message text)."""

    def __init__(self, msg: str, missing_token=None):
        super().__init__(msg)
        self.missing_token = missing_token


class LocalCluster(ClusterBackend):
    """N worker processes on this machine, each with
    ``devices_per_process`` logical partitions on ``device`` — the
    built-in "local" ClusterBackend (runtime/interfaces.py seam).
    ``fn_modules`` are imported by workers to resolve plan callables
    (FN_TABLE exports + module:qualname refs into them)."""

    # the address the control listener binds and the workers dial, and
    # the host of the gang's gloo rendezvous (worker 0's process): this
    # machine's loopback.  A backend with workers elsewhere
    # (runtime/ssh_cluster.py) binds the address those workers reach and
    # names worker 0's host
    _bind_host = "127.0.0.1"
    coordinator_host = "127.0.0.1"

    @classmethod
    def from_config(cls, config, **kw) -> "LocalCluster":
        """Build from a JobConfig's cluster_* fields (``kw`` overrides)."""
        base = dict(n_processes=config.cluster_processes,
                    devices_per_process=config.cluster_devices_per_process,
                    fn_modules=tuple(config.cluster_fn_modules),
                    startup_timeout=config.cluster_startup_timeout_s)
        base.update(kw)
        return cls(**base)

    def __init__(self, n_processes: int = 2, devices_per_process: int = 2,
                 fn_modules: tuple = (), startup_timeout: float = 180.0,
                 event_log: Optional[Callable[[dict], None]] = None,
                 log_dir: Optional[str] = None, device="cuda"):
        # the device first: without CUDA no worker is spawned
        self.device = self._resolve_device(device)
        self.n_processes = n_processes
        self.devices_per_process = devices_per_process
        self.fn_modules = list(fn_modules)
        self.startup_timeout = startup_timeout
        self.event_log = event_log
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="dryad-cluster-")
        os.makedirs(self.log_dir, exist_ok=True)
        # per-cluster control-plane secret: every accepted connection
        # must answer an HMAC challenge BEFORE any pickle is decoded
        # (pickle executes code on load; protocol.server_authenticate).
        # Workers get it via their process environment, never on a
        # command line
        import secrets as _secrets
        self._secret: Optional[bytes] = _secrets.token_bytes(32)
        self._procs: List[subprocess.Popen] = []
        self._socks: Dict[int, socket.socket] = {}
        # elastic (standalone) workers joined mid-life: they serve farm
        # tasks like the gang (reference dynamic registration,
        # LocalScheduler/Queues.cs:104)
        self._elastic: set = set()
        self._elastic_procs: Dict[int, subprocess.Popen] = {}
        # monotonic: a dropped member's pid is never reused (reuse would
        # overwrite a LIVE worker's socket/process entries)
        self._elastic_seq = 0
        # per-worker receive buffers persist ACROSS jobs (cleared only on
        # restart): a speculated task's losing duplicate reply may arrive
        # after the farm returns, possibly split across recv() calls — a
        # call-local buffer would discard the partial prefix and leave the
        # next job decoding from mid-frame
        self._bufs: Dict[int, bytearray] = {}
        self._listener: Optional[socket.socket] = None
        # monotonic job id: every submission is tagged, workers echo it,
        # and schedulers discard stale replies (a finished farm may leave
        # an ignored-duplicate reply in flight — see runtime/farm.py)
        self._job_seq = 0
        # resident tokens queued for release (their Dataset was dropped):
        # they live on the CLUSTER, whose workers hold the memory, and
        # ride the next gang job of any Context
        self.pending_release: List[str] = []
        self._start()

    def _resolve_device(self, device) -> str:
        """The workers' device type: they run on this machine, so CUDA
        is checked here (``parallel.mesh.resolve_device``)."""
        from dryad_tpu_torch.parallel.mesh import resolve_device
        return resolve_device(device).type

    def next_job_id(self) -> int:
        self._job_seq += 1
        return self._job_seq

    def _emit(self, event: dict) -> None:
        """Structured failure/lifecycle events into the driver's event
        stream."""
        if self.event_log is not None:
            try:
                self.event_log(event)
            except Exception:
                pass

    @property
    def nparts(self) -> int:
        return self.n_processes * self.devices_per_process

    # -- lifecycle ---------------------------------------------------------

    def _accept_worker(self, conn) -> Optional[int]:
        """Authenticate an accepted connection and register the worker
        its hello names; None (connection closed) for a peer that fails
        the challenge."""
        if not protocol.server_authenticate(conn, self._secret):
            conn.close()   # wrong secret / not our worker: reject
            return None
        hello = protocol.recv_msg(conn)
        conn.setblocking(False)
        pid = hello["hello"]
        self._socks[pid] = conn
        self._bufs[pid] = bytearray()
        return pid

    def _start(self) -> None:
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._bind_host, 0))
        self._listener.listen(self.n_processes)
        control_port = self._listener.getsockname()[1]
        # the gang's gloo rendezvous (worker 0 hosts its store)
        coord_port = _free_port()
        for pid in range(self.n_processes):
            self._procs.append(self._spawn_worker(pid, control_port,
                                                  coord_port))
        deadline = time.time() + self.startup_timeout
        self._listener.settimeout(1.0)
        while len(self._socks) < self.n_processes:
            if time.time() > deadline:
                self._kill_all()
                raise WorkerFailure(
                    f"only {len(self._socks)}/{self.n_processes} workers "
                    f"connected within {self.startup_timeout}s"
                    + self._log_tails())
            self._check_deaths()
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            self._accept_worker(conn)

    def _spawn_worker(self, pid: int, control_port: int,
                      coord_port: Optional[int] = None
                      ) -> subprocess.Popen:
        """A gang member (``coord_port``: the gloo rendezvous), or with
        None an elastic ``--standalone`` worker outside the gang."""
        env = package_env()
        if self._secret is not None:
            # in-memory env dict of a direct child: on no command line
            env["DRYAD_CONTROL_SECRET"] = self._secret.hex()
        cmd = [sys.executable, "-m", "dryad_tpu_torch.runtime.worker",
               "--control", f"{self._bind_host}:{control_port}",
               "--process-id", str(pid),
               "--devices-per-process", str(self.devices_per_process),
               "--device", self.device]
        if coord_port is None:
            cmd.append("--standalone")
        else:
            cmd += ["--coordinator", f"{self.coordinator_host}:{coord_port}",
                    "--num-processes", str(self.n_processes)]
        for m in self.fn_modules:
            cmd += ["--fn-module", m]
        log = open(os.path.join(self.log_dir, f"worker-{pid}.log"), "ab")
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        log.close()
        return proc

    def add_worker(self, timeout: float = 120.0) -> int:
        """Register one ELASTIC worker mid-life (the reference's dynamic
        computer registration, LocalScheduler/Queues.cs:104-137): a
        ``--standalone`` process outside the gang that serves farm tasks
        on its own device like the others; gang jobs ignore it.  Returns
        the new worker's pid."""
        if not self.alive():
            self.restart()   # also recreates the listener after teardown
        pid = self.n_processes + self._elastic_seq
        self._elastic_seq += 1
        control_port = self._listener.getsockname()[1]
        proc = self._spawn_worker(pid, control_port)
        deadline = time.time() + timeout
        self._listener.settimeout(1.0)
        try:
            while True:
                if time.time() > deadline:
                    raise WorkerFailure(
                        f"elastic worker {pid} did not connect within "
                        f"{timeout}s" + self._log_tails())
                if proc.poll() is not None:
                    raise WorkerFailure(
                        f"elastic worker {pid} exited rc={proc.returncode}"
                        + self._log_tails())
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                hp = self._accept_worker(conn)
                if hp is None:
                    continue
                self._elastic.add(hp)
                # register the process only once it is CONNECTED: a
                # failed join must not leave a phantom in worker_procs()
                self._elastic_procs[hp] = proc
                return hp
        except BaseException:
            if proc.poll() is None:
                proc.kill()
            raise

    def gang_pids(self):
        return [p for p in self._socks if p not in self._elastic]

    # public ClusterBackend aliases of the farm-facing surface
    @property
    def sockets(self) -> Dict[int, socket.socket]:
        return self._socks

    def recv_frames(self, pid: int, job: int):
        """One non-blocking drain of ``pid``'s socket: ``(replies for
        job, alive)``; frames of other jobs (a losing speculative
        duplicate's late reply) are discarded."""
        frames, ok = self.recv_frames_any(pid)
        return [r for r in frames if r.get("job") == job], ok

    def recv_frames_any(self, pid: int):
        """One non-blocking drain of ``pid``'s socket returning EVERY
        complete frame regardless of job tag (the job service's cluster
        fleet routes each frame by its ``protocol.JOB_ID`` tag itself):
        ``(frames, alive)``.  ``alive=False`` means the socket is closed
        or broken, or its stream lost framing (which poisons only this
        worker)."""
        got = self._drain_socket(pid)
        if got is not True:
            return [], got is False       # None = dead, False = no data
        out: List[dict] = []
        try:
            while True:
                r = protocol.try_decode(self._bufs[pid])
                if r is None:
                    break
                out.append(r)
        except protocol.FrameError:
            return out, False
        return out, True

    def log_tails(self) -> str:
        return self._log_tails()

    def _drop_elastic(self, pid: int) -> None:
        """Remove one dead/unresponsive ELASTIC worker — optional
        members never take the gang down with them."""
        s = self._socks.pop(pid, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        self._bufs.pop(pid, None)
        self._elastic.discard(pid)
        proc = self._elastic_procs.pop(pid, None)
        if proc is not None and proc.poll() is None:
            proc.kill()

    def worker_procs(self) -> Dict[int, subprocess.Popen]:
        """pid -> process for EVERY task-capable worker (gang +
        elastic)."""
        out = {pid: proc for pid, proc in enumerate(self._procs)}
        out.update(self._elastic_procs)
        return out

    def worker_hosts(self) -> Dict[int, str]:
        """pid -> machine name, for block->host locality hints (the
        reference's computer table feeding affinity resolution,
        Interfaces.cs:98-152): every LocalCluster worker runs here."""
        host = socket.gethostname()
        return {pid: host for pid in self._socks}

    def _check_deaths(self) -> None:
        """During start-up: a worker that exited fails the start (with
        its log's tail)."""
        for pid, proc in enumerate(self._procs):
            if proc.poll() is not None:
                self._emit({"event": "worker_failed", "worker": pid,
                            "error": f"process exited with "
                                     f"rc={proc.returncode}",
                            "log_tails": self._log_tails(800)})
                self._kill_all()
                raise WorkerFailure(
                    f"worker {pid} exited with rc={proc.returncode}"
                    + self._log_tails())

    def _log_tails(self, n: int = 2000) -> str:
        out = []
        for pid in (list(range(self.n_processes))
                    + sorted(self._elastic_procs)):
            p = os.path.join(self.log_dir, f"worker-{pid}.log")
            try:
                with open(p, "rb") as f:
                    f.seek(max(0, os.path.getsize(p) - n))
                    tail = f.read().decode(errors="replace")
                if tail.strip():
                    out.append(f"\n--- worker {pid} log tail ---\n{tail}")
            except OSError:
                pass
        return "".join(out)

    def _kill_all(self) -> None:
        everyone = list(self._procs) + list(self._elastic_procs.values())
        for proc in everyone:
            if proc.poll() is None:
                proc.kill()
        for proc in everyone:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._procs, self._socks, self._bufs = [], {}, {}
        self._elastic, self._elastic_procs = set(), {}
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def alive(self) -> bool:
        return (len(self.gang_pids()) == self.n_processes
                and all(p.poll() is None for p in self._procs))

    def restart(self) -> None:
        self._kill_all()
        self._start()

    def shutdown(self) -> None:
        for s in self._socks.values():
            try:
                s.setblocking(True)
                s.settimeout(5.0)
                protocol.send_msg(s, {"cmd": "stop"})
            except OSError:
                pass
        # give the workers a moment to exit on their own (a CUDA context
        # is released more cleanly by exit than by SIGKILL)
        deadline = time.time() + 5.0
        for proc in list(self._procs) + list(self._elastic_procs.values()):
            try:
                proc.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        self._kill_all()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __del__(self):
        # a dropped cluster must not leak worker processes: workers
        # linger on a severed control socket (by design, see
        # retire_worker), so the driver-side GC is the line of defense
        try:
            self._kill_all()
        except Exception:
            pass

    def _drain_socket(self, pid: int) -> Optional[bool]:
        """One non-blocking recv into ``pid``'s frame buffer.  True =
        bytes buffered, False = nothing to read right now, None = socket
        closed/broken (the caller treats the worker as dead)."""
        s = self._socks.get(pid)
        if s is None:
            return None
        try:
            chunk = s.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return None
        if not chunk:
            return None
        self._bufs[pid].extend(chunk)
        return True

    def wait_quiescent(self, timeout: float = 60.0) -> None:
        """Block until every worker answers a fresh ping — i.e. has
        drained all previously queued work (a losing speculative
        duplicate from a prior farm run, for example).  Useful before
        timing-sensitive submissions."""
        job = self.next_job_id()
        for pid, s in list(self._socks.items()):
            try:
                s.setblocking(True)
                protocol.send_msg(s, {"cmd": "ping", "job": job})
                s.setblocking(False)
            except OSError:
                if pid in self._elastic:
                    # a dead OPTIONAL member never takes the gang down
                    self._drop_elastic(pid)
                    continue
                self._kill_all()
                raise WorkerFailure(
                    f"worker {pid} unreachable during quiescence ping"
                    + self._log_tails())
        pending = set(self._socks)
        deadline = time.time() + timeout
        while pending:
            if time.time() > deadline:
                if pending <= self._elastic:
                    for pid in list(pending):
                        self._drop_elastic(pid)
                    return
                raise WorkerFailure(
                    f"workers {sorted(pending)} not quiescent after "
                    f"{timeout}s" + self._log_tails())
            socks = {self._socks[p]: p for p in pending}
            ready, _, _ = select.select(list(socks), [], [], 0.25)
            for s in ready:
                pid = socks[s]
                frames, ok = self.recv_frames(pid, job)
                if not ok:
                    if pid in self._elastic:
                        self._drop_elastic(pid)
                        pending.discard(pid)
                        continue
                    self._kill_all()
                    raise WorkerFailure(
                        f"worker {pid} closed its control connection"
                        + self._log_tails())
                for r in frames:
                    if "pong" in r:
                        pending.discard(pid)

    def retire_worker(self, pid: int) -> None:
        """Remove one worker from scheduling by severing its control
        socket (the reference abandons the vertex on timeout,
        ReactToFailedVertex).  The process is not killed: it notices the
        severed socket and lingers (runtime/worker.py) until the next
        restart kills it; severing alone already keeps a half-written
        reply from wedging the next job's blocking send.  The cluster is
        no longer ``alive()`` afterwards, so the next farm restarts it."""
        s = self._socks.pop(pid, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        self._bufs.pop(pid, None)

    # -- gang jobs ---------------------------------------------------------

    def execute(self, plan_json: str,
                source_specs: Dict[str, Dict[str, Any]],
                collect: Any = True, store_path: Optional[str] = None,
                store_partitioning: Optional[Dict[str, Any]] = None,
                config=None, timeout: float = 600.0,
                keep_token: Optional[str] = None,
                release: tuple = (),
                store_compression: Optional[str] = None) -> Dict[str, Any]:
        """Submit one job to the gang; returns worker 0's reply with the
        host table under "table" (the workers' parts concatenated in pid
        order, which is partition order), its extras (``stage_log``,
        ``salted``, ``resident_capacity``, ``graph_rewrites``), and under
        ``workers`` every worker's ``launches``, ``staged`` collectives,
        ``stage_log``, the seconds its process has spent building
        kernels (``compile_s``) and, for a streamed plan, ``stream`` (its waves,
        retries, spilled bytes and range bounds), by pid.  ``config``
        (a JobConfig) rides the control message, so the driver's knobs
        apply on the workers; ``keep_token`` keeps the output resident
        there; ``release`` (and the cluster's ``pending_release``)
        drops tokens."""
        from dryad_tpu_torch.obs import trace
        if not self.alive():
            self.restart()
        job = self.next_job_id()
        queued = self.pending_release[:]
        del self.pending_release[:len(queued)]
        hb_every = config.gang_heartbeat_s if config is not None else 2.0
        # the driver's job span: its context rides the envelope so the
        # workers' spans parent-link here; no attached log means level 0,
        # no span work, and no trace context for the workers either
        with trace.span(f"job {job}", "job",
                        sink=trace.leveled(
                            self._emit,
                            getattr(self.event_log, "level", None)
                            if self.event_log is not None else 0),
                        job=job) as jsp:
            msg = protocol.attach_trace(
                {"cmd": "run", "plan": plan_json, "sources": source_specs,
                 "collect": collect, "store_path": store_path,
                 "store_partitioning": store_partitioning, "job": job,
                 "config": config, "keep_token": keep_token,
                 "release": list(release) + queued,
                 "store_compression": store_compression,
                 "hb_every": hb_every}, trace.ctx_of(jsp))
            for pid in self.gang_pids():
                s = self._socks[pid]
                s.setblocking(True)
                protocol.send_msg(s, msg)
                s.setblocking(False)
            replies = self._gather_job_replies(job, timeout, "job",
                                               config=config)
        if self.event_log is not None and 0 in replies:
            for e in replies[0].get("events", []):
                self.event_log(dict(e, worker=0))
        reply0 = dict(replies.get(0, {}))
        reply0["workers"] = {pid: {k: r.get(k) for k in (
            "launches", "staged", "stage_log", "stream", "compile_s",
            "graph_rewrites")}
            for pid, r in replies.items()}
        if collect and collect != "count":
            # the parallel collect: each column's parts joined once
            import numpy as np
            by_col: Dict[str, list] = {}
            for pid in sorted(replies):
                for k, v in (replies[pid].get("table_part") or {}).items():
                    by_col.setdefault(k, []).append(v)
            reply0["table"] = {
                k: ([x for p in parts for x in p]
                    if isinstance(parts[0], list) else
                    np.concatenate(parts)) for k, parts in by_col.items()}
        return reply0

    def _gather_job_replies(self, job: int, timeout: float, what: str,
                            config=None) -> Dict[int, dict]:
        """One reply per gang worker for ``job``.  On an error reply the
        others get a 5 s grace (so co-errors reach the diagnosis) and the
        gang is torn down; ClusterJobError carries the first error, the
        forensics bundle's path and any worker's lost resident token.

        The straggler / wedge watchdog (the reference duplicates a slow
        vertex, DrVertex.h:195; a gang cannot duplicate one member, so it
        replays): workers beat every ``gang_heartbeat_s`` while a job
        runs; a worker silent past ``gang_heartbeat_timeout_s``, or one
        that misses the margin after the first reply (max(rel x the
        first reply's latency, abs seconds)) with its beats stopped too,
        is declared wedged (``worker_wedged``), the gang is torn down
        and WorkerFailure lets the driver replay the job on a fresh gang.
        A worker past the margin whose beats still flow is slow, not
        wedged, and runs on to the heartbeat timeout or the deadline."""
        hb_every = config.gang_heartbeat_s if config is not None else 2.0
        hb_timeout = (config.gang_heartbeat_timeout_s
                      if config is not None else 60.0)
        rel = (config.gang_straggler_rel_margin
               if config is not None else 1.0)
        abs_m = (config.gang_straggler_abs_margin_s
                 if config is not None else 15.0)
        replies: Dict[int, dict] = {}
        pending = set(self.gang_pids())
        t0 = time.time()
        deadline = t0 + timeout
        first_reply_at: Optional[float] = None
        last_seen: Dict[int, float] = {p: t0 for p in pending}

        def _wedged(pids, why: str):
            self._emit({"event": "worker_wedged", "workers": sorted(pids),
                        "why": why, "what": what,
                        "log_tails": self._log_tails(800)})
            self._kill_all()
            raise WorkerFailure(
                f"{what}: workers {sorted(pids)} {why} — declared wedged; "
                f"gang torn down for replay" + self._log_tails())

        def _take(pid) -> bool:
            """Drain ``pid``; False when its socket died."""
            nonlocal first_reply_at
            frames, ok = self.recv_frames(pid, job)
            if frames:
                last_seen[pid] = time.time()
            for r in frames:
                if "hb" in r:          # liveness only, not a reply
                    continue
                replies[pid] = r
                pending.discard(pid)
                if first_reply_at is None:
                    first_reply_at = time.time()
            return ok

        while pending:
            now = time.time()
            if now > deadline:
                self._kill_all()
                raise WorkerFailure(
                    f"{what} timed out after {timeout}s; workers "
                    f"{sorted(pending)} never replied" + self._log_tails())
            if hb_every > 0:
                silent = [p for p in pending
                          if now - last_seen[p] > hb_timeout]
                if silent:
                    _wedged(silent, f"sent no heartbeat for "
                                    f">{hb_timeout:g}s")
                if first_reply_at is not None:
                    margin = max(rel * (first_reply_at - t0), abs_m)
                    hb_stale = max(3 * hb_every, 10.0)
                    frozen = [p for p in pending
                              if now - last_seen[p] > hb_stale]
                    if now > first_reply_at + margin and frozen:
                        _wedged(frozen,
                                f"missed the straggler margin "
                                f"({margin:.1f}s after the first reply) "
                                f"with heartbeats stopped >{hb_stale:g}s")
            self._check_deaths()
            socks = {self._socks[pid]: pid for pid in pending}
            ready, _, _ = select.select(list(socks), [], [], 0.25)
            for s in ready:
                pid = socks[s]
                if not _take(pid):
                    self._kill_all()
                    raise WorkerFailure(
                        f"worker {pid} closed its control connection "
                        f"mid-{what}" + self._log_tails())
            if pending and any(not r.get("ok") for r in replies.values()):
                # a worker that failed before a collective leaves the
                # others blocked in it: a short grace, then tear down
                grace = time.time() + 5.0
                while pending and time.time() < grace:
                    socks = {self._socks[p]: p for p in pending}
                    ready, _, _ = select.select(list(socks), [], [], 0.25)
                    for s in ready:
                        if not _take(socks[s]):
                            pending.discard(socks[s])
                break

        errs = {pid: r["error"] for pid, r in replies.items()
                if not r.get("ok")}
        if errs:
            self._emit({"event": "job_failed", "what": what,
                        "workers": sorted(errs), "error": errs[min(errs)],
                        "log_tails": self._log_tails(800)})
            bpath = self._persist_forensics(replies, sorted(errs), config)
            self._kill_all()   # the gang's state is unknown after an error
            first = min(errs)
            # any failing worker's lost-token tag makes the job healable
            tok = next((replies[p]["missing_token"] for p in sorted(errs)
                        if replies[p].get("missing_token") is not None),
                       None)
            raise ClusterJobError(
                f"{what} failed on worker(s) {sorted(errs)}; worker "
                f"{first} error:\n{errs[first]}"
                + (f"\nforensics bundle: {bpath}\n"
                   f"  reproduce locally: python -m dryad_tpu_torch.obs "
                   f"replay {bpath}" if bpath else ""),
                missing_token=tok)
        return replies

    def _persist_forensics(self, replies: Dict[int, dict], err_pids,
                           config) -> Optional[str]:
        """Persist the first failing worker's flight-recorder bundle (the
        raised error quotes that worker; the others usually fail as
        collective aborts of the same cause).  Best effort."""
        from dryad_tpu_torch.obs import flight
        for pid in err_pids:
            path = flight.persist_reply_forensics(
                replies[pid], config, self.event_log, self._emit)
            if path:
                return path
        return None
