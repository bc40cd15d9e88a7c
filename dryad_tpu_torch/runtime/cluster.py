"""Driver-side cluster control plane: spawn workers, detect process
failure, restart — the port of ``dryad_tpu/runtime/cluster.py`` for the
task farm.

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
whole plan on one worker.  A gang SPMD job across the workers
(``execute``) needs an exchange across processes, which comes with the
gang half of ROADMAP Queue 1 item 11: it raises before anything is sent.
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
           "GANG_LATER", "package_env"]

# what a gang SPMD job (execute) is answered with
GANG_LATER = ("gang SPMD jobs across the worker processes need an "
              "exchange across processes: they come with the gang half "
              "of ROADMAP Queue 1 item 11 (LocalCluster serves farm tasks: "
              "runtime.farm.TaskFarm, the job service's cluster fleet)")


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
    """A job raised on a worker (plan/UDF/capacity error)."""


class LocalCluster(ClusterBackend):
    """N worker processes on this machine, each with
    ``devices_per_process`` logical partitions on ``device`` — the
    built-in "local" ClusterBackend (runtime/interfaces.py seam).
    ``fn_modules`` are imported by workers to resolve plan callables
    (FN_TABLE exports + module:qualname refs into them)."""

    def __init__(self, n_processes: int = 2, devices_per_process: int = 2,
                 fn_modules: tuple = (), startup_timeout: float = 180.0,
                 event_log: Optional[Callable[[dict], None]] = None,
                 log_dir: Optional[str] = None, device="cuda"):
        from dryad_tpu_torch.parallel.mesh import resolve_device
        # the device first: without CUDA no worker is spawned
        self.device = resolve_device(device).type
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
        self._start()

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
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.n_processes)
        control_port = self._listener.getsockname()[1]
        for pid in range(self.n_processes):
            self._procs.append(self._spawn_worker(pid, control_port))
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

    def _spawn_worker(self, pid: int, control_port: int
                      ) -> subprocess.Popen:
        env = package_env()
        if self._secret is not None:
            # in-memory env dict of a direct child: on no command line
            env["DRYAD_CONTROL_SECRET"] = self._secret.hex()
        cmd = [sys.executable, "-m", "dryad_tpu_torch.runtime.worker",
               "--control", f"127.0.0.1:{control_port}",
               "--process-id", str(pid),
               "--devices-per-process", str(self.devices_per_process),
               "--device", self.device]
        for m in self.fn_modules:
            cmd += ["--fn-module", m]
        log = open(os.path.join(self.log_dir, f"worker-{pid}.log"), "ab")
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        log.close()
        return proc

    def add_worker(self, timeout: float = 120.0) -> int:
        """Register one ELASTIC worker mid-life (the reference's dynamic
        computer registration, LocalScheduler/Queues.cs:104-137): it
        serves farm tasks on its own device like the others.  Returns
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

    def execute(self, plan_json: str, source_specs: Dict[str, Any],
                **kw) -> Dict[str, Any]:
        """A gang SPMD job across the workers: refused (ValueError,
        ``GANG_LATER``) before anything is sent."""
        raise ValueError(GANG_LATER)

