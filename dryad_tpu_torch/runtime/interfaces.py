"""Cluster backend seam + factory registry — the port of
``dryad_tpu/runtime/interfaces.py``.

The reference separates the GM engine from any concrete scheduler behind
`ICluster`/`IScheduler` with a name-keyed factory registry
(ClusterInterface/Interfaces.cs:324,491,545) — the same scheduler code
serves local spawns and YARN containers.  This module is that seam for
the port: everything driver-side (the task farm, the job service's
cluster fleet) runs against :class:`ClusterBackend`, and new deployment
targets register themselves by name without touching the core.

``runtime.LocalCluster`` is the built-in "local" backend: real OS worker
processes on one box, each on its own device (the CUDA card by default)
— the reference's LocalJobSubmission topology — and the gang's SPMD
jobs across them (``execute``).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional

__all__ = ["ClusterBackend", "register_cluster", "make_cluster",
           "cluster_backends"]


class ClusterBackend(abc.ABC):
    """The driver-side contract every cluster implementation provides.

    Gang jobs (SPMD plans, streamed wave jobs) broadcast to the fixed
    gang; farm tasks may additionally use elastic members.  See
    LocalCluster for reference semantics of each operation."""

    n_processes: int
    event_log: Optional[Callable[[dict], None]]

    @property
    @abc.abstractmethod
    def nparts(self) -> int:
        """Total data partitions the gang serves (devices across it)."""

    @abc.abstractmethod
    def alive(self) -> bool:
        """True when the full gang is connected and running."""

    @abc.abstractmethod
    def restart(self) -> None:
        """Tear down and re-form the gang (resident state is lost)."""

    @abc.abstractmethod
    def shutdown(self) -> None:
        """Stop all workers and release resources."""

    @abc.abstractmethod
    def next_job_id(self) -> int:
        """Monotonic job tag; workers echo it so schedulers can discard
        stale replies."""

    @abc.abstractmethod
    def execute(self, plan_json: str, source_specs: Dict[str, Any],
                **kw) -> Dict[str, Any]:
        """Run one gang SPMD plan; returns worker 0's reply (collected
        tables merged from per-worker parts)."""

    # -- task-farm surface (per-task scheduling over gang + elastic) -------

    @property
    @abc.abstractmethod
    def sockets(self) -> Dict[int, Any]:
        """pid -> control socket for every CONNECTED worker (gang and
        elastic) — the farm's dispatch/ping surface."""

    @abc.abstractmethod
    def worker_procs(self) -> Dict[int, Any]:
        """pid -> OS process handle for every task-capable worker (the
        farm's liveness poll)."""

    @abc.abstractmethod
    def recv_frames(self, pid: int, job: int):
        """One non-blocking drain of pid's socket: (replies_for_job,
        alive)."""

    @abc.abstractmethod
    def retire_worker(self, pid: int) -> None:
        """Remove one wedged worker from scheduling (sever its socket)."""

    @abc.abstractmethod
    def log_tails(self) -> str:
        """Recent worker log excerpts for failure diagnostics."""


# -- factory registry (Interfaces.cs:545 Factory.Register parity) -----------

_FACTORIES: Dict[str, Callable[..., "ClusterBackend"]] = {}


def register_cluster(name: str, factory: Callable[..., "ClusterBackend"]
                     ) -> None:
    """Register/replace a cluster backend under ``name``."""
    _FACTORIES[name.lower()] = factory


def cluster_backends() -> list:
    return sorted(_FACTORIES)


def make_cluster(name: str = "local", **kw) -> "ClusterBackend":
    """Instantiate a registered backend: ``make_cluster("local",
    n_processes=4)``."""
    fn = _FACTORIES.get(name.lower())
    if fn is None:
        raise KeyError(
            f"no cluster backend {name!r} registered (known: "
            f"{cluster_backends()}); register one with "
            f"runtime.interfaces.register_cluster")
    return fn(**kw)
