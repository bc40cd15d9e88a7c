"""SSH submission backend: one gang worker per remote host — the port of
``dryad_tpu/runtime/ssh_cluster.py``.

The second deployment target behind the ClusterBackend seam (the
reference ships local processes and YARN behind one interface:
LinqToDryad/LocalJobSubmission.cs:35, YarnJobSubmission.cs:38, with
Peloponnese staging the resources and launching the process groups,
PeloponneseJobSubmission.cs:111-147).  Per host it:

  1. STAGES the code: the installed ``dryad_tpu_torch`` package, its
     kernel sources (``ops/csrc/*.cu``, ``*.cuh``, ``host_fnv.c``)
     included and nothing built, is tarred on the driver and unpacked
     into ``remote_root`` over the remote shell's stdin (no shared
     filesystem assumed).  A staged worker builds the kernels from those
     sources into ``<remote_root>/build/kernels`` at its first launch
     (``ops/_build.py``; one build per root: the workers of one host
     share it under a ``flock``);
  2. writes the control secret to a 0600 file there, over stdin;
  3. launches ``python -m dryad_tpu_torch.runtime.worker --device
     <device>`` with the addresses a remote process can reach: the gloo
     rendezvous at ``coordinator_host`` (worker 0's host) and the
     control socket at ``driver_host``.

The control plane (``runtime/cluster.py``: gang formation, failure
detection through the local transport process, job submission,
restart, the task farm) runs unchanged on top.

The remote-shell TRANSPORT is pluggable: ``rsh(host, command) -> argv``,
by default ``ssh -o BatchMode=yes <host> <command>``.  The tests inject
``bash -c`` (no sshd needed), which runs everything but the ssh binary:
the staging through the transport's stdin, the addressing, the
bootstrap, the gang's SPMD jobs, the teardown.  Lookup:
``make_cluster("ssh", hosts=[...])``.
"""

from __future__ import annotations

import io
import os
import shlex
import socket
import subprocess
import tarfile
import time
from typing import Callable, List, Optional, Sequence

from dryad_tpu_torch.runtime.cluster import LocalCluster, WorkerFailure

__all__ = ["SshCluster", "default_rsh"]


def default_rsh(host: str, command: str) -> List[str]:
    """The ssh argv of one remote shell command (BatchMode: never
    prompt).  ``accept-new`` pins a host key on first contact instead of
    turning verification off (a transport someone sits in the middle of
    would hand them the staged control secret)."""
    return ["ssh", "-o", "BatchMode=yes",
            "-o", "StrictHostKeyChecking=accept-new", host, command]


def _route_source_addr(target: str) -> str:
    """The local interface address that routes toward ``target`` (a UDP
    connect sends no packet).  Falls back to the hostname's resolution,
    then the loopback: the HMAC challenge still guards what we bind."""
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect((target, 9))
            return probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _staged(ti: tarfile.TarInfo) -> Optional[tarfile.TarInfo]:
    """The tar's filter: sources only — no ``__pycache__``, no ``build/``
    directory, no built library."""
    parts = ti.name.split("/")
    if "__pycache__" in parts or "build" in parts[1:]:
        return None
    if ti.name.endswith((".so", ".pyc", ".lock")):
        return None
    return ti


def _package_tar() -> bytes:
    """One tar.gz of the installed ``dryad_tpu_torch`` package with its
    kernel sources (the staged "wheel")."""
    import dryad_tpu_torch
    pkg_dir = os.path.dirname(os.path.abspath(dryad_tpu_torch.__file__))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        tf.add(pkg_dir, arcname="dryad_tpu_torch", filter=_staged)
    return buf.getvalue()


class SshCluster(LocalCluster):
    """One gang worker per entry of ``hosts`` (repeat a host for several
    workers on it), launched over a remote shell.

    Beyond LocalCluster's parameters: ``hosts`` (the remote targets);
    ``driver_host`` (the address the remote workers reach THIS process
    at; by default the interface that routes to the first host);
    ``python`` (the remote interpreter); ``remote_root`` (the staging
    directory, by default one per driver process under /tmp);
    ``stage_code`` (False: ``dryad_tpu_torch`` is importable remotely
    already); ``device`` (``"cuda"``, the default: each worker runs on
    its host's card and raises there without CUDA; ``"cpu"``: the plain
    PyTorch versions, the test topology); ``coordinator_host`` (the gloo
    rendezvous, worker 0's host by default); ``remote_pythonpath``
    (extra remote import roots, e.g. the hosts' UDF modules); ``rsh``
    (the transport, see the module docstring).

    ``stage_s`` is the seconds the staging of every host took."""

    def __init__(self, hosts: Sequence[str],
                 devices_per_process: int = 1,
                 driver_host: Optional[str] = None,
                 python: str = "python3",
                 remote_root: Optional[str] = None,
                 stage_code: bool = True,
                 device: str = "cuda",
                 coordinator_host: Optional[str] = None,
                 remote_pythonpath: Sequence[str] = (),
                 rsh: Callable[[str, str], List[str]] = default_rsh,
                 **kw):
        self.hosts = list(hosts)
        if not self.hosts:
            raise ValueError("SshCluster needs at least one host")
        self.driver_host = driver_host or socket.gethostname()
        # bind the control listener to the SPECIFIC address the workers
        # dial, never 0.0.0.0: the HMAC challenge guards the pickle
        # decoder, but the port need not face every interface.  A given
        # driver_host resolves to that address; by default a route probe
        # toward the first host finds it (one's own hostname may resolve
        # to a loopback alias such as 127.0.1.1, which remote workers
        # cannot reach)
        if driver_host:
            try:
                self._bind_host = socket.gethostbyname(driver_host)
            except OSError as e:
                raise ValueError(
                    f"driver_host {driver_host!r} does not resolve to a "
                    f"bindable address: {e}") from e
        else:
            # advertise the probed address too: a remote resolution of
            # the driver's bare hostname may differ from the interface
            # that routes to the workers
            self._bind_host = _route_source_addr(self.hosts[0])
            self.driver_host = self._bind_host
        # the gloo rendezvous lives in worker 0's process: its host by
        # default (a test transport runs every "remote" worker here)
        self.coordinator_host = coordinator_host or self.hosts[0]
        self.python = python
        self.remote_root = remote_root or f"/tmp/dryad-ssh-{os.getpid()}"
        self.stage_code = stage_code
        self.remote_pythonpath = list(remote_pythonpath)
        self._rsh = rsh
        self._staged_hosts: set = set()
        self._tar: Optional[bytes] = None
        self.stage_s = 0.0
        super().__init__(n_processes=len(self.hosts),
                         devices_per_process=devices_per_process,
                         device=device, **kw)

    def _resolve_device(self, device) -> str:
        """The workers' device, checked on their own hosts: the driver
        owns no device, so a CUDA check here would test the wrong
        machine.  Only the name is checked."""
        name = str(device)
        if name not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        return name

    def worker_hosts(self):
        """pid -> host: gang workers map onto their remote target, elastic
        joiners (``add_worker``, local) onto this machine — the map the
        farm's block-to-host locality hints resolve against
        (Interfaces.cs:98-152's affinity role)."""
        local = socket.gethostname()
        return {pid: (self.hosts[pid] if pid < len(self.hosts) else local)
                for pid in self._socks}

    # -- staging (PeloponneseJobSubmission.cs:111-147's role) --------------

    def _stage(self, host: str) -> None:
        if host in self._staged_hosts:
            return
        t0 = time.perf_counter()
        if self.stage_code:
            if self._tar is None:
                self._tar = _package_tar()
            cmd = (f"mkdir -p {shlex.quote(self.remote_root)} && "
                   f"tar xzf - -C {shlex.quote(self.remote_root)}")
            p = subprocess.run(self._rsh(host, cmd), input=self._tar,
                               capture_output=True, timeout=120)
            if p.returncode != 0:
                raise WorkerFailure(
                    f"staging to {host} failed (rc={p.returncode}): "
                    f"{p.stderr.decode(errors='replace')[-500:]}")
        # with no code to ship the secret still travels by file: the only
        # channel that keeps it off command lines
        self._stage_secret(host)
        self._staged_hosts.add(host)
        self.stage_s += time.perf_counter() - t0

    def _stage_secret(self, host: str) -> None:
        """Write the cluster's control secret to a 0600 remote file over
        the remote shell's STDIN — never on a command line (visible in
        ps) nor in the launch's environment prefix (part of the ssh
        command string).  The workers read it through
        ``DRYAD_CONTROL_SECRET_FILE`` and answer the driver's HMAC
        challenge with it (``protocol.server_authenticate``)."""
        path = self._secret_path()
        cmd = (f"umask 077 && mkdir -p {shlex.quote(self.remote_root)} && "
               f"cat > {shlex.quote(path)}")
        p = subprocess.run(self._rsh(host, cmd),
                           input=self._secret.hex().encode(),
                           capture_output=True, timeout=60)
        if p.returncode != 0:
            raise WorkerFailure(
                f"secret staging to {host} failed (rc={p.returncode}): "
                f"{p.stderr.decode(errors='replace')[-500:]}")

    def _secret_path(self) -> str:
        return os.path.join(self.remote_root, ".control-secret")

    # -- spawn (one remote worker per host entry) --------------------------

    def _spawn_worker(self, pid: int, control_port: int,
                      coord_port: Optional[int] = None
                      ) -> subprocess.Popen:
        host = self.hosts[pid % len(self.hosts)]
        self._stage(host)
        envs = {"DRYAD_WORKER_ID": str(pid),
                "DRYAD_CONTROL_SECRET_FILE": self._secret_path(),
                # -m would put the remote cwd ahead of the staged root
                "PYTHONSAFEPATH": "1"}
        pypath = ([self.remote_root] if self.stage_code else []) \
            + self.remote_pythonpath
        if pypath:
            envs["PYTHONPATH"] = os.pathsep.join(pypath)
        args = [self.python, "-m", "dryad_tpu_torch.runtime.worker",
                "--control", f"{self.driver_host}:{control_port}",
                "--process-id", str(pid),
                "--devices-per-process", str(self.devices_per_process),
                "--device", self.device]
        if coord_port is None:
            args.append("--standalone")
        else:
            args += ["--coordinator", f"{self.coordinator_host}:{coord_port}",
                     "--num-processes", str(self.n_processes)]
        for m in self.fn_modules:
            args += ["--fn-module", m]
        command = "env " + " ".join(
            f"{k}={shlex.quote(v)}" for k, v in envs.items()) + " " + \
            " ".join(shlex.quote(a) for a in args)
        log = open(os.path.join(self.log_dir, f"worker-{pid}.log"), "ab")
        proc = subprocess.Popen(self._rsh(host, command), stdout=log,
                                stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL)
        log.close()
        return proc


def _register() -> None:
    from dryad_tpu_torch.runtime.interfaces import register_cluster
    register_cluster("ssh", SshCluster)


_register()
