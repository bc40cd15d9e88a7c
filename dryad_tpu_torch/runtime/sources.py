"""Deferred source descriptions for cluster execution — the port of
``dryad_tpu/runtime/sources.py``.

In single-process mode a Context constructor places data on its device
immediately; in cluster mode the driver owns no device, so a source is a
SPEC — "these columns", "this text file", "this store path" — shipped
with the plan and materialized by the worker that runs it (the
reference's data-provider model: the plan names input partition files,
vertices read them; DataProvider.cs, DrPartitionFile.cpp:607).  The
spec dicts are the JAX package's, key for key.

A gang worker (``runtime/exec_common.py``) builds only its own
partitions of a spec, at the capacity a one-process build over all the
gang's partitions gives them (``exec/data.py``, ``io/store.read_store``).
A ``resident`` spec names a cluster-resident intermediate by its token
(a ``cache()``, a ``do_while``'s loop state): the worker hands out the
PData it kept, and a token it does not hold (the gang restarted since)
raises ``MissingResidentToken``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

__all__ = ["DeferredSource", "columns_spec", "text_spec", "store_spec",
           "preferred_worker_for_partitions", "locality_hints_for_store",
           "farm_store_tasks", "build_source", "count_lines",
           "count_lines_file", "MissingResidentToken"]


class MissingResidentToken(KeyError):
    """A plan referenced a cluster-resident token this worker does not
    hold (the gang restarted since it was cached).  Carries the token as
    structured data: the worker copies ``.token`` into its error reply's
    ``missing_token`` field, and the driver's healing
    (``api/dataset.Context._lost_resident_token``) reads that field,
    never the message text."""

    def __init__(self, token: str):
        super().__init__(
            f"resident token {token!r} not present on this worker — the "
            f"gang restarted since it was cached; re-run the producing "
            f"query")
        self.token = token

    def __str__(self) -> str:  # KeyError quotes its argument
        return self.args[0]


class DeferredSource:
    """Planner-visible stand-in for source data (exposes ``.capacity``
    the way PData does)."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec

    @property
    def capacity(self) -> int:
        return self.spec["capacity"]


def _block_capacity(n: int, nparts: int) -> int:
    """Per-partition capacity of block partitioning — must match
    exec.data._block_slices (max block = ceil split)."""
    base, rem = divmod(n, nparts)
    return max(1, base + (1 if rem else 0))


def count_lines(buf: bytes) -> int:
    """Line count matching the text packer's splitting (split on \\n, a
    trailing unterminated line counts)."""
    n = buf.count(b"\n")
    if buf and not buf.endswith(b"\n"):
        n += 1
    return n


def count_lines_file(path: str, chunk: int = 1 << 22) -> int:
    """Streaming line count — the driver never holds the file in memory
    (it only needs the capacity estimate; workers read the data)."""
    n = 0
    last = b""
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            n += b.count(b"\n")
            last = b
    if last and not last.endswith(b"\n"):
        n += 1
    return n


def columns_spec(columns: Mapping[str, Any], nparts: int,
                 capacity: int | None = None,
                 str_max_len: int = 64) -> Dict[str, Any]:
    n = 0
    for v in columns.values():
        n = len(v)
        break
    return {"kind": "columns", "columns": dict(columns),
            "capacity": capacity or _block_capacity(n, nparts),
            "str_max_len": str_max_len}


def text_spec(path, nparts: int, column: str = "line",
              max_line_len: int = 256) -> Dict[str, Any]:
    """``path``: one file path or a list of file paths (already expanded
    by io.providers.expand_paths; workers read them from the shared
    filesystem).  ``rows`` is the exact line count, which the static
    cost model seeds its row intervals from."""
    paths = [path] if isinstance(path, str) else list(path)
    n = sum(count_lines_file(p) for p in paths)
    return {"kind": "text", "paths": paths, "column": column,
            "max_line_len": max_line_len, "rows": n,
            "capacity": _block_capacity(n, nparts)}


def store_spec(path: str, nparts: int, meta: Dict[str, Any],
               capacity: int | None = None,
               partitions: list | None = None,
               preferred_worker: int | None = None,
               preferred_hosts: list | None = None) -> Dict[str, Any]:
    """``partitions`` restricts to the listed store partitions — the
    per-task input granularity for farming a big store (one task per
    partition group, DrPartitionFile.cpp:607 role).  ``preferred_worker``
    (a worker pid) and ``preferred_hosts`` (machine names holding the
    partitions' blocks, e.g. from hdfs GETFILEBLOCKLOCATIONS via
    ``locality_hints_for_store``) are soft locality hints the task farm
    honors when a matching worker is available (the reference's weighted
    affinity lists from block locations,
    ClusterInterface/Interfaces.cs:98-152).  The manifest's exact rows
    and schema ride the spec for the static cost model."""
    counts = meta.get("counts", [])
    if partitions is not None:
        counts = [counts[p] for p in partitions]
    if partitions is None and meta["npartitions"] == nparts:
        cap = capacity or max(int(meta.get("capacity", 0)),
                              max(counts or [0]), 1)
    else:
        cap = capacity or _block_capacity(sum(counts), nparts)
    return {"kind": "store", "path": path, "capacity": cap,
            "partitions": partitions,
            "rows": int(sum(counts)) if counts else None,
            "schema": meta.get("schema"),
            "preferred_worker": preferred_worker,
            "preferred_hosts": (list(preferred_hosts)
                                if preferred_hosts else None)}


def farm_store_tasks(path: str, src_key: str, nparts_local: int,
                     meta: Dict[str, Any] | None = None,
                     group_size: int = 1,
                     n_processes: int | None = None) -> list:
    """Per-task source specs for farming a partitioned store over a
    TaskFarm: one task per ``group_size`` store partitions, each spec
    carrying the best available locality hint — block->host hints for
    ``hdfs://`` stores (``locality_hints_for_store``), writer affinity
    for local parallel-output stores (pass ``n_processes``).  Use:
    ``TaskFarm(cl).run(plan_json, farm_store_tasks(...))``.

    ``src_key`` is the plan's source binding key (from
    shiplan.serialize_for_cluster); ``nparts_local`` the per-worker
    partition count (``LocalCluster.devices_per_process``)."""
    import concurrent.futures

    from dryad_tpu_torch.io.store import store_meta
    meta = meta or store_meta(path)
    nparts = meta["npartitions"]
    groups = [list(range(i, min(i + group_size, nparts)))
              for i in range(0, nparts, group_size)]
    # hint lookups hit the namenode once per partition: prefetch every
    # group's concurrently
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, max(len(groups), 1))) as pool:
        all_hints = list(pool.map(
            lambda g: locality_hints_for_store(path, g, meta), groups))
    tasks = []
    for g, hosts in zip(groups, all_hints):
        w = (preferred_worker_for_partitions(g, nparts, n_processes)
             if n_processes else None)
        tasks.append({src_key: store_spec(
            path, nparts_local, meta, partitions=g,
            preferred_worker=w, preferred_hosts=hosts or None)})
    return tasks


def locality_hints_for_store(path: str, partitions,
                             meta: Dict[str, Any] | None = None
                             ) -> list:
    """Block->host locality hints for the given store partitions, for
    ``store_spec(..., preferred_hosts=)``: real for ``hdfs://`` stores
    (GETFILEBLOCKLOCATIONS), empty for stores without host-addressed
    blocks (local fs, s3) — locality is always a HINT."""
    if path.startswith("hdfs://"):
        from dryad_tpu_torch.io.webhdfs import hdfs_preferred_hosts
        return hdfs_preferred_hosts(path, partitions)
    return []


def preferred_worker_for_partitions(partitions, npartitions: int,
                                    n_processes: int) -> int | None:
    """The worker that WROTE (and likely page-caches) the given store
    partitions under the parallel-output layout: worker w writes
    partitions [w*dpp, (w+1)*dpp).  Returns the majority holder, or None
    when the layout doesn't divide evenly."""
    if n_processes <= 1 or npartitions % n_processes:
        return None
    dpp = npartitions // n_processes
    owners = [p // dpp for p in partitions]
    if not owners:
        return None
    return max(set(owners), key=owners.count)


def build_source(spec: Dict[str, Any], mesh, verify: bool = True,
                 resident=None):
    """Materialize a source spec as a PData on ``mesh`` (a worker's own
    device and partitions).  ``verify`` checks a store's partition
    checksums (``JobConfig.store_verify_checksums``); ``resident`` is the
    gang worker's token -> PData cache."""
    kind = spec["kind"]
    if kind == "resident":
        tok = spec["token"]
        if resident is None or tok not in resident:
            raise MissingResidentToken(tok)
        return resident[tok]
    if kind == "columns":
        from dryad_tpu_torch.exec.data import pdata_from_host
        return pdata_from_host(spec["columns"], mesh,
                               capacity=spec["capacity"],
                               str_max_len=spec["str_max_len"])
    if kind == "text":
        from dryad_tpu_torch.exec.data import pdata_from_packed_strings
        from dryad_tpu_torch.io.providers import read_text_files
        paths = spec.get("paths") or [spec["path"]]
        data, lens, _ = read_text_files(paths, spec["max_line_len"])
        return pdata_from_packed_strings(data, lens, mesh,
                                         column=spec["column"],
                                         capacity=spec["capacity"])
    if kind == "store":
        from dryad_tpu_torch.io.store import read_store
        return read_store(spec["path"], mesh, capacity=spec["capacity"],
                          partitions=spec.get("partitions"),
                          verify=verify)
    raise ValueError(f"unknown source kind {kind!r}")
