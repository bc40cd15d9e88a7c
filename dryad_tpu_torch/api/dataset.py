"""User-facing API: ``Context`` and the lazy ``Dataset`` — the subset of
``dryad_tpu/api/dataset.py`` that WordCount, GroupByReduce, TeraSort,
PageRank and k-means call, with the sort family (``order_by``,
``range_partition``, the ``assume_*`` claims, ``take``, ``distinct``,
``group_top_k``, ``group_median``), ``join`` (inner / left / right /
full, hash or broadcast, hot-key salted on skew), ``group_join``,
``cross_apply``, ``broadcast``, the set operators (``union``,
``intersect``, ``except_``, ``concat``), the positional operators
(``zip_with``, ``with_row_index``, ``skip``, ``take_while``,
``skip_while``, ``sliding_window``), ``flat_map``, ``group_apply``,
``apply_per_partition`` / ``apply_with_partition_index``, ``fork`` /
``fork_by`` / ``fork_on``, ``assume_hash_partition``,
``with_capacity``, the in-memory ``cache``,
``Context.do_while`` and the terminal scalars (``count``, ``sum``,
``min``, ``max``, ``mean``, ``any``, ``all``, ``first``,
``aggregate``).

``Context(device="cuda", nparts=8)`` runs ``nparts`` logical partitions
on one CUDA card (``parallel/mesh.py``).  The device is CUDA unless the
caller asks for the CPU; on a machine without CUDA the default raises
rather than quietly running on the CPU.  ``Context(mesh=make_mesh(
device, n, hosts=, pods=))`` runs on a mesh of named axes, ``(dcn, dp)``
or ``(dcn, host, dp)``: its group-bys plan one combine stage per axis,
innermost first (``groupby-dp``, ``groupby-dcn``), each exchanging over
its axis only.  ``event_log`` receives the
executor's events (``utils/events.EventLog``), and ``spill_dir`` makes
every query spill each stage's output as a store and resume from it
(``exec/recovery.py``).  Stores: ``Context.from_store``,
``Dataset.to_store`` (``io/store.py``), and ``Context.read_text`` (one
row per line of local text files, ``io/providers.py``).

Streamed (out-of-core) data: ``Context.from_stream`` (an
``exec.ooc.ChunkSource``), ``read_store_stream``, ``read_text_stream``,
and ``from_store`` of a store with at least
``JobConfig.ooc_auto_stream_rows`` rows.  A query over a streamed source
is planned with ONE logical partition and runs over chunk streams
(``exec/stream_exec.py``), the device holding O(chunk_rows) rows whatever
the data size; ``collect``, ``count``, the scalars, ``to_store``,
``cache`` and ``do_while`` take it.  ``cache()`` of streamed data (and of
edge-scale in-memory data, DTA204) writes a local chunked store keyed by
the query's stable fingerprint and re-streams it on later passes (the
re-streaming cache tier, ``JobConfig.ooc_restream_cache``).

``Context(local_debug=True)`` is the reference's LocalDebug: the
terminal calls (``collect``, ``count``, the scalars, ``cache``,
``do_while``) run the sequential oracle (``oracle.run_oracle``) over
the sources' host tables instead of the executor; the sources are still
built on the Context's device.  ``Dataset.cost()`` is the static cost
model's report for the plan a terminal call would run
(``analysis/cost.py``); ``JobConfig(adaptive="on")`` lets the executor
rewrite the plan's remaining stages from measured rows (``adapt/``).

``Dataset.check()`` is the static checker's report (the plan rules and
the UDF lint, ``analysis/``), ``Dataset.explain(verify=, cost=)`` the
plan with it and the cost table; ``JobConfig(lint="warn" | "error")``
runs both before every in-memory or streamed submission
(``Context._pre_submit_lint``).  ``Context(fn_table=)`` names callables
registered for shipping.  The SQL front end (``sql/``) lowers a query
into these same calls.

``Context(cluster=LocalCluster(...))`` targets worker processes: the
driver owns no device, and ``from_columns``, ``read_text`` and
``from_store`` make deferred sources (``runtime/sources.py``) that a
plan ships with (``runtime/shiplan.serialize_for_cluster``).  The
context's ``nparts`` is the gang's (``n_processes x
devices_per_process``), and every terminal (``collect``, ``count``,
``to_store``, the scalars, ``cache``, ``do_while``) is a gang SPMD job
(``_cluster_run``: ``LocalCluster.execute``, ``runtime/exec_common.py``)
whose result equals the in-process run at the same ``nparts``.  A gang
of more than one process plans the JAX package's levels ``("dp",
"dcn")``, so it equals the in-process run on ``make_mesh(device,
nparts, hosts=n_processes)``: ``dcn`` is the process boundary.
``cache()`` and a ``do_while``'s loop state stay resident on the workers
under a token (only the plan and the token cross the driver's socket),
and a token a gang restart lost is healed by re-running its producing
plan.  The task farm and the job service's cluster fleet size their
tasks from the cluster's ``devices_per_process``, never from the
context.  A streamed query on a cluster Context (``read_store_stream``,
and ``read_text_stream`` / ``from_stream``, whose driver-side stream is
first spooled into a store under ``JobConfig.cluster_stream_spool_dir``)
is a gang job too: the plan runs as chunk waves across the workers
(``runtime/stream_plan.py``), and its ``cache()`` is a store the gang
writes in parallel and later queries stream.  ``analyze()`` refuses a
cluster Context.

Telemetry (``obs/``): a Context installs its ``event_log`` as the
process's span sink (the latest Context owns it; ``install_trace=False``
opts out), and ``JobConfig.history_dir`` makes that log archive the job
when it closes.  With a sink installed, an in-process terminal's job
runs in a ``query`` root span (``terminal``: collect, cache, count,
to_store or the scalar's kind), so all its spans share one trace id:
``plan`` (the planning, the lint and the cost report, up to the
executor's run; ``stages``), the Run's ``run`` and its spans, then the
terminal's own work on the output, ``collect`` (the shrink and the copy
to the host) or ``cache``.  ``Dataset.analyze()`` /
``explain(analyze=True)`` is
EXPLAIN ANALYZE: the query runs once under its own level-2 capture and
the measured per-stage actuals come back against the cost model
(``obs/analyze.py``).
"""

from __future__ import annotations

import dataclasses as _dc
import hashlib
import itertools
import os
import shutil
import tempfile
import types
import uuid
import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch import oracle as _oracle
from dryad_tpu_torch.exec.data import PData, maybe_shrink_for_collect, \
    pdata_from_host, pdata_from_packed_strings, pdata_to_host, \
    split_partitions
from dryad_tpu_torch.exec.executor import Executor
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.ops.kernels import scalar_aggregate
from dryad_tpu_torch.parallel.mesh import Mesh, resolve_device
from dryad_tpu_torch.plan import expr as E
from dryad_tpu_torch.plan.planner import plan_query
from dryad_tpu_torch.utils.config import JobConfig

__all__ = ["Context", "Dataset"]


def _add_agg_key(cols):
    """The columns plus a zero int32 ``__agg_key`` (one global group for
    the whole-dataset ``aggregate``)."""
    v = next(iter(cols.values()))
    t = v.lengths if hasattr(v, "lengths") else v
    return dict(cols, __agg_key=torch.zeros(t.shape[0], dtype=torch.int32,
                                            device=t.device))


def _first_if_one(v):
    v = np.asarray(v)
    return v[0] if v.shape and v.shape[0] == 1 else v


# ---------------------------------------------------------------------------
# stable query fingerprints (the re-streaming cache's keys)

# the fallback salt of values with no restart-stable identity (device
# data, opaque closures): an entry keyed through it stays valid within
# THIS process (warm do_while iterations still hit), and a restarted job
# re-streams cold (a miss, never a stale hit)
_PROCESS_SALT = uuid.uuid4().hex

# id() reuse guard of the salt fallback: a monotonic sequence pinned to
# each object through a weakref, so a garbage-collected object's id
# reused by a new one cannot alias its key; objects without weakrefs get
# a fresh sequence per call (always a miss)
_LOCAL_ID_SEQ = itertools.count()
_LOCAL_IDS: Dict[int, Any] = {}     # id -> (weakref, seq)


def _local_identity(v) -> str:
    ent = _LOCAL_IDS.get(id(v))
    if ent is not None and ent[0]() is v:
        return f"local:{_PROCESS_SALT}:{ent[1]}"
    seq = next(_LOCAL_ID_SEQ)
    try:
        def _drop(ref, k=id(v)):
            cur = _LOCAL_IDS.get(k)
            if cur is not None and cur[0] is ref:
                del _LOCAL_IDS[k]
        _LOCAL_IDS[id(v)] = (weakref.ref(v, _drop), seq)
    except TypeError:
        pass
    return f"local:{_PROCESS_SALT}:{seq}"


def _code_const_fp(c) -> str:
    """repr() of a code constant, except nested code objects (whose repr
    holds a memory address) recurse into bytecode and constants, and
    frozensets list in sorted order (their iteration order depends on
    PYTHONHASHSEED)."""
    if isinstance(c, types.CodeType):
        inner = ",".join(_code_const_fp(x) for x in c.co_consts)
        return f"code({c.co_name},{c.co_code.hex()},[{inner}])"
    if isinstance(c, frozenset):
        return "frozenset{" + ",".join(sorted(map(repr, c))) + "}"
    if isinstance(c, tuple):
        return "(" + ",".join(_code_const_fp(x) for x in c) + ")"
    return repr(c)


def _stable_fn_fp(fn) -> Optional[str]:
    """Restart-stable identity of a user callable: module / qualname,
    bytecode, constants and hashable closure / default values; None when
    its behavior hangs on values that do not hash byte-exactly (bound
    objects, large arrays), and the caller falls back to the process
    salt (a miss, never a stale hit)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    parts = [getattr(fn, "__module__", "") or "", fn.__qualname__,
             code.co_code.hex()]
    try:
        parts.append(_code_const_fp(code.co_consts))
    except Exception:
        return None
    captured = []
    if getattr(fn, "__closure__", None):
        try:
            captured.extend(c.cell_contents for c in fn.__closure__)
        except ValueError:          # empty cell
            return None
    captured.extend(getattr(fn, "__defaults__", None) or ())
    for v in captured:
        if isinstance(v, (int, float, complex, str, bytes, bool,
                          type(None))):
            parts.append(repr(v))
        elif isinstance(v, np.ndarray) and v.nbytes <= (1 << 20):
            parts.append(hashlib.sha256(
                np.ascontiguousarray(v).tobytes()).hexdigest())
        else:
            return None
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _stable_value_fp(v) -> str:
    if callable(v):
        return _stable_fn_fp(v) or _local_identity(v)
    if isinstance(v, E.Decomposable):
        return "dec(" + ",".join(
            _stable_value_fp(getattr(v, part))
            for part in ("seed", "merge", "finalize")) + ")"
    if isinstance(v, np.ndarray):
        if v.nbytes <= (1 << 20):
            return hashlib.sha256(
                np.ascontiguousarray(v).tobytes()).hexdigest()
        return _local_identity(v)
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k!r}:{_stable_value_fp(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_stable_value_fp(x) for x in v) + "]"
    if isinstance(v, (int, float, complex, str, bytes, bool,
                      type(None))):
        return repr(v)
    if _dc.is_dataclass(v) and not isinstance(v, type):
        inner = ",".join(
            f"{f.name}={_stable_value_fp(getattr(v, f.name))}"
            for f in _dc.fields(v))
        return f"{type(v).__name__}({inner})"
    return _local_identity(v)


def _stable_source_fp(data) -> str:
    """Content identity of a Source node's data: a stored or text-file
    stream carries a fingerprint over its path and checksums
    (``ChunkSource.from_store`` / ``from_text``), so changed source
    bytes change the key; so does a cluster's ``store_stream`` spec, over
    its store's manifest; anything else takes the process salt."""
    from dryad_tpu_torch.exec.stream_exec import StreamSource
    cs = data.cs if isinstance(data, StreamSource) else data
    fp = getattr(cs, "fingerprint", None)
    if fp:
        return fp
    spec = getattr(data, "spec", None)
    if isinstance(spec, dict) and spec.get("kind") == "store_stream":
        try:
            from dryad_tpu_torch.io.store import store_meta
            meta = store_meta(spec["path"])
            return hashlib.sha256(repr(
                ("store", spec["path"], meta.get("counts"),
                 meta.get("checksums"))).encode()).hexdigest()
        except Exception:
            pass
    return _local_identity(data)


def _stable_node_fp(root: E.Node) -> str:
    """Restart-stable structural fingerprint of a query DAG, the
    re-streaming cache key: the logical nodes parents-first, each as its
    type and every dataclass field (callables by bytecode and captures,
    sources by content identity); anything unhashable folds in the
    process salt, so an uncertain key can only MISS across restarts."""
    parts = []
    ids: Dict[int, int] = {}
    for i, n in enumerate(E.walk(root)):
        ids[n.id] = i
        fields = []
        for f in _dc.fields(n):
            if f.name in ("parents", "host"):
                continue
            v = getattr(n, f.name)
            if f.name == "data":
                fields.append(f"data={_stable_source_fp(v)}"
                              if v is not None else "data=None")
            else:
                fields.append(f"{f.name}={_stable_value_fp(v)}")
        parents = ",".join(str(ids[p.id]) for p in n.parents)
        parts.append(f"{type(n).__name__}({parents})[{';'.join(fields)}]")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


class Context:
    """Owns the mesh + executor and creates root Datasets."""

    def __init__(self, device=None, nparts: Optional[int] = None,
                 config: JobConfig | None = None,
                 event_log: Optional[Callable[[dict], None]] = None,
                 spill_dir: Optional[str] = None,
                 local_debug: bool = False,
                 fn_table: Optional[Mapping[str, Any]] = None,
                 install_trace: bool = True, cluster=None, mesh=None):
        """``device`` (default "cuda") and ``nparts`` (default 8) make a
        one-axis mesh; a ``mesh`` (``parallel.mesh.make_mesh``) gives
        both, and a ``device`` or ``nparts`` that contradicts it
        raises."""
        self.config = config or JobConfig()
        self.local_debug = local_debug
        # names of callables registered for shipping: the analyzer's
        # cluster rules treat them as shippable, and a serialized plan
        # (plan/serialize.py) re-binds them by name
        self.fn_table = dict(fn_table or {})
        self.cluster = cluster
        self.spill_dir = spill_dir
        self._event_log = event_log
        if cluster is not None:
            # the driver owns no device: sources are deferred specs that
            # ship with the plan, run SPMD over the gang's partitions
            self.mesh = None
            self.executor = None
            # n_processes x devices_per_process (a backend that names no
            # process count is one process)
            n_proc = getattr(cluster, "n_processes", 1)
            self.nparts = n_proc * cluster.devices_per_process
            # the workers' mesh is (dcn, dp), dcn the process boundary:
            # the JAX package's levels
            self.hosts = n_proc
            self.levels = ("dp", "dcn") if n_proc > 1 else ()
            self._token_seq = 0
            # token -> the plan node that produced it: a gang restart
            # wipes resident state, and a query touching a lost token
            # re-materializes it from this lineage and retries
            self._resident_producers: Dict[str, Any] = {}
        else:
            if mesh is None:
                mesh = Mesh(resolve_device(device or "cuda"), nparts or 8)
            elif ((device is not None
                   and torch.device(device) != torch.device(mesh.device))
                  or (nparts is not None and nparts != mesh.nparts)):
                raise ValueError(
                    f"Context(device={device!r}, nparts={nparts!r}) "
                    f"contradicts its mesh ({mesh.device}, "
                    f"{mesh.nparts} partitions)")
            self.mesh = mesh
            self.nparts = mesh.nparts
            # a multi-level mesh plans hierarchical aggregation: one
            # level per axis, innermost first
            names = mesh.axis_names
            self.hosts = mesh.axes[0][1] if len(names) >= 2 else 1
            self.levels = tuple(reversed(names)) if len(names) >= 2 else ()
            self.executor = Executor(self.mesh, event_log=event_log,
                                     config=self.config)
        # the process span sink is the LATEST Context's log, a log-less
        # Context's None included: a later job's spans never leak into an
        # earlier job's JSONL
        if install_trace:
            from dryad_tpu_torch.obs import trace
            trace.install(event_log)
        # JobConfig.history_dir makes the attached EventLog archive the
        # job on close; an explicit EventLog(history_dir=) wins
        if (self.config.history_dir and event_log is not None
                and getattr(event_log, "history_dir", "absent") is None):
            event_log.history_dir = self.config.history_dir

    @property
    def device(self):
        """The context's device (None on a cluster Context: its workers
        hold the devices)."""
        return self.mesh.device if self.mesh is not None else None

    # -- gang submission ---------------------------------------------------

    def _cluster_run(self, node, collect: Any = True,
                     store_path: Optional[str] = None,
                     store_partitioning: Optional[Dict[str, Any]] = None,
                     keep_token: Optional[str] = None,
                     want_reply: bool = False,
                     store_compression: Optional[str] = None,
                     lint: bool = True):
        """Plan, serialize and submit one query to the gang; the host
        table, or with ``want_reply`` worker 0's whole reply.  A job lost
        to a dead or wedged worker is replayed once on a fresh gang (its
        sources are re-readable); a job that touched a resident token the
        gang lost re-materializes it from its producer first (chained
        residents heal recursively)."""
        from dryad_tpu_torch.runtime.cluster import (ClusterJobError,
                                                     WorkerFailure)
        from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster
        graph = plan_query(node, self.nparts, hosts=self.hosts,
                           levels=self.levels, config=self.config)
        if lint:
            self._pre_submit_lint(node, cluster=True, graph=graph)
        plan_json, specs = serialize_for_cluster(graph, self.fn_table)
        # the workers' events go to THIS context's log for the job
        # (several contexts may share one cluster)
        prev_log = self.cluster.event_log
        self.cluster.event_log = self._event_log
        replayed = False
        try:
            for heal in range(8):   # bounds the healing retries
                try:
                    reply = self.cluster.execute(
                        plan_json, specs, collect=collect,
                        store_path=store_path,
                        store_partitioning=store_partitioning,
                        config=self.config,
                        timeout=self.config.cluster_job_timeout_s,
                        keep_token=keep_token,
                        store_compression=store_compression)
                    break
                except WorkerFailure:
                    if replayed or heal == 7:
                        raise
                    replayed = True
                except ClusterJobError as e:
                    tok = self._lost_resident_token(e)
                    if tok is None or heal == 7:
                        raise
                    self._cluster_run(self._resident_producers[tok],
                                      collect=False, keep_token=tok)
        finally:
            self.cluster.event_log = prev_log
        return reply if want_reply else reply.get("table")

    def _lost_resident_token(self, err) -> Optional[str]:
        """The healable token of a lost-resident job error (its producer
        is registered): read from ``ClusterJobError.missing_token``, set
        from the worker reply's structured field."""
        tok = getattr(err, "missing_token", None)
        if tok is not None and tok in self._resident_producers:
            return tok
        return None

    def _fresh_token(self, tag: str) -> str:
        self._token_seq += 1
        return f"__{tag}_{id(self):x}_{self._token_seq}"

    def _resident_dataset(self, token: str, capacity: int,
                          partitioning: E.Partitioning =
                          E.Partitioning.none(),
                          producer: Any = None) -> "Dataset":
        """A Dataset over a cluster-resident intermediate: its queries
        ship only the token.  When its source node is collected, the
        token joins the CLUSTER's release list (riding the next job of
        any Context: the workers hold the memory).  ``producer``, the
        plan node that computed it, lets a lost token heal."""
        from dryad_tpu_torch.runtime.sources import DeferredSource
        node = E.Source(parents=(), data=DeferredSource(
            {"kind": "resident", "token": token, "capacity": capacity}),
            _npartitions=self.nparts, _partitioning=partitioning)
        if producer is not None:
            self._resident_producers[token] = producer
            weakref.finalize(node, self._resident_producers.pop, token,
                             None)
        weakref.finalize(node, self.cluster.pending_release.append, token)
        return Dataset(self, node)

    # -- pre-submit static analysis (analysis/) ----------------------------

    def _pre_submit_lint(self, node, cluster: bool = False, graph=None):
        """The ``JobConfig.lint`` gate: verify the plan and lint its UDFs
        BEFORE any executor work starts.  "warn" logs the findings
        (``lint_finding`` events); "error" refuses to submit on
        error-severity findings (``analysis.LintError``).

        With ``graph`` (the already-planned StageGraph: planning is
        deterministic, so it is what the executor runs) the static cost
        pass runs too: its DTA2xx findings join the report, and a
        ``cost_report`` event carries the machine-readable report the
        executor cross-checks (``cost_model_miss``).  Returns the
        CostReport, or None."""
        mode = self.config.lint
        if mode == "off":
            return None
        from dryad_tpu_torch.analysis import LintError, check_plan
        report = check_plan(node, cluster=cluster, fn_table=self.fn_table)
        cost_rep = None
        if graph is not None:
            from dryad_tpu_torch.analysis.cost import (cost_diagnostics,
                                                       estimate_graph)
            cost_rep = estimate_graph(graph, self.nparts,
                                      config=self.config)
            report.diagnostics.extend(cost_diagnostics(cost_rep,
                                                       self.config))
        report.dedup()
        ev = self._event_log
        if ev is not None:
            for d in report:
                ev({"event": "lint_finding", "code": d.code,
                    "severity": d.severity, "message": d.message,
                    "node": d.node,
                    "span": str(d.span) if d.span else None})
            if cost_rep is not None:
                ev({"event": "cost_report",
                    "report": cost_rep.to_payload()})
        if mode == "error" and report.errors:
            raise LintError(report)
        return cost_rep

    def from_columns(self, columns: Mapping[str, Any],
                     capacity: int | None = None,
                     str_max_len: int | None = None) -> "Dataset":
        """A partitioned dataset from host columns (block-partitioned
        rows; lists of str/bytes become string columns).  The source
        keeps the caller's columns for the oracle (by reference)."""
        str_max_len = str_max_len or self.config.string_max_len
        if self.cluster is not None:
            from dryad_tpu_torch.runtime.sources import (DeferredSource,
                                                         columns_spec)
            spec = columns_spec(columns, self.nparts, capacity=capacity,
                                str_max_len=str_max_len)
            return Dataset(self, E.Source(parents=(),
                                          data=DeferredSource(spec),
                                          _npartitions=self.nparts,
                                          host=dict(columns)))
        pdata = pdata_from_host(columns, self.mesh, capacity=capacity,
                                str_max_len=str_max_len)
        return Dataset(self, E.Source(parents=(), data=pdata,
                                      _npartitions=self.nparts,
                                      host=dict(columns)))

    def from_pdata(self, pdata: PData,
                   partitioning: E.Partitioning = E.Partitioning.none(),
                   host: Optional[Mapping[str, Any]] = None
                   ) -> "Dataset":
        """A dataset over data already on the mesh, with the partitioning
        it is claimed to have (a cached or loop-carried result keeps its
        hash placement, so later joins and group-bys skip the
        exchange); ``host``, the same rows on the host, for the
        oracle."""
        return Dataset(self, E.Source(parents=(), data=pdata,
                                      _npartitions=self.nparts,
                                      _partitioning=partitioning,
                                      host=host))

    def read_text(self, path, column: str = "line",
                  max_line_len: int | None = None) -> "Dataset":
        """One row per line of text (LineRecord): ``path`` is a file, a
        glob, a directory or a list of those, read and packed in
        parallel, the lines block-partitioned in file order.  Lines are
        cut at ``max_line_len`` bytes (default
        ``JobConfig.text_max_line_len``)."""
        from dryad_tpu_torch.io.providers import expand_paths, \
            read_text_files
        max_line_len = max_line_len or self.config.text_max_line_len
        if self.cluster is not None:
            from dryad_tpu_torch.runtime.sources import (DeferredSource,
                                                         text_spec)
            spec = text_spec(expand_paths(path), self.nparts,
                             column=column, max_line_len=max_line_len)
            return Dataset(self, E.Source(parents=(),
                                          data=DeferredSource(spec),
                                          _npartitions=self.nparts))
        data, lens, _ = read_text_files(expand_paths(path), max_line_len)
        # the lines as host bytes only for the oracle: a per-line Python
        # object is what read_text otherwise avoids
        host = ({column: [bytes(r[:n]) for r, n in zip(data, lens)]}
                if self.local_debug else None)
        return self.from_pdata(pdata_from_packed_strings(
            data, lens, self.mesh, column=column), host=host)

    # -- streamed (out-of-core) sources ------------------------------------

    def from_stream(self, source) -> "Dataset":
        """A streamed Dataset over an ``exec.ooc.ChunkSource``: a query
        over it plans with one logical partition and runs over chunk
        streams (``exec/stream_exec.py``), the device holding
        O(chunk_rows) rows whatever the data size.

        On a cluster Context a driver-side stream cannot run on the
        workers, so the driver SPOOLS it into a store they reach
        (``JobConfig.cluster_stream_spool_dir``, a shared filesystem or
        ``hdfs://``; ``s3://`` is refused, having no atomic commit of a
        chunk stream; default a driver temporary directory, which serves
        a one-machine cluster) and the gang streams that store
        (FromEnumerable parity: DryadLinqContext.cs:1210)."""
        from dryad_tpu_torch.exec.stream_exec import StreamSource
        if self.cluster is not None:
            import uuid

            from dryad_tpu_torch.exec.ooc import write_chunks_to_store
            root = (self.config.cluster_stream_spool_dir
                    or tempfile.mkdtemp(prefix="dryad-spool-"))
            name = f"stream-{uuid.uuid4().hex[:10]}"
            path = (root.rstrip("/") + "/" + name if "://" in root
                    else os.path.join(root, name))
            write_chunks_to_store(path, iter(source), source.schema)
            return self.read_store_stream(path,
                                          chunk_rows=source.chunk_rows)
        return Dataset(self, E.Source(parents=(), data=StreamSource(source),
                                      _npartitions=1))

    def read_store_stream(self, path: str,
                          chunk_rows: int | None = None) -> "Dataset":
        """Stream a store (written by either package; local, ``s3://`` or
        ``hdfs://``) through the plain Dataset API, ``chunk_rows`` rows a
        chunk (default: the autotuned size with
        ``JobConfig.ooc_chunk_autotune``, else
        ``JobConfig.ooc_chunk_rows``).

        On a cluster Context the query plans at the gang's partitions,
        exchanges included, and the gang runs it as chunk waves with
        per-partition bucket streams (``runtime/stream_plan.py``): each
        worker streams its own partitions of the store."""
        from dryad_tpu_torch.exec.ooc import ChunkSource
        cr = chunk_rows or self._auto_chunk_rows(path) \
            or self.config.ooc_chunk_rows
        if self.cluster is not None:
            from dryad_tpu_torch.runtime.sources import DeferredSource
            spec = {"kind": "store_stream", "path": path,
                    "chunk_rows": cr, "capacity": cr}
            return Dataset(self, E.Source(parents=(),
                                          data=DeferredSource(spec),
                                          _npartitions=self.nparts))
        return self.from_stream(ChunkSource.from_store(path, cr))

    def _auto_chunk_rows(self, store_path: str) -> int | None:
        """Measured chunk sizing (``JobConfig.ooc_chunk_autotune``): the
        row width from the store's schema, the copy rate and dispatch
        floor from a one-time probe on this context's device
        (``exec/autotune``).  A heuristic: any failure gives None."""
        if not self.config.ooc_chunk_autotune:
            return None
        try:
            from dryad_tpu_torch.exec.autotune import pick_chunk_rows
            from dryad_tpu_torch.io.store import store_meta
            row_bytes = lanes = 0
            for spec in store_meta(store_path)["schema"].values():
                if spec["kind"] == "str":
                    row_bytes += int(spec["max_len"]) + 4
                    lanes += -(-int(spec["max_len"]) // 4) + 1
                else:
                    w = int(np.dtype(spec["dtype"]).itemsize)
                    n_el = int(np.prod(spec.get("shape", ()),
                                       dtype=np.int64))
                    row_bytes += w * n_el
                    lanes += max(1, w // 4) * n_el
            return pick_chunk_rows(row_bytes, self.config, row_lanes=lanes,
                                   device=self.device)
        except Exception:
            return None

    def read_text_stream(self, path, column: str = "line",
                         chunk_rows: int | None = None,
                         max_line_len: int | None = None) -> "Dataset":
        """Stream text files line by line (a file is never held in
        memory whole); ``path`` as for ``read_text``, or a ``http://``,
        ``s3://`` or ``hdfs://`` URI (a listing URL, an ``s3://`` prefix
        ending in ``/`` or an ``hdfs://`` directory streams every file in
        it), read by ranged requests.  On a cluster Context the lines are
        spooled into a store first (``from_stream``)."""
        from dryad_tpu_torch.exec.ooc import ChunkSource
        from dryad_tpu_torch.io.providers import expand_uris
        return self.from_stream(ChunkSource.from_text(
            expand_uris(path), chunk_rows or self.config.ooc_chunk_rows,
            max_line_len or self.config.text_max_line_len, column))

    def read(self, uri: str, **kw) -> "Dataset":
        """URI-scheme dispatch: ``file://`` text, ``store://`` a
        partitioned store, ``http://`` ranged GETs, ``s3://`` objects,
        ``hdfs://`` WebHDFS, and any scheme registered with
        ``io.providers.register_provider``."""
        from dryad_tpu_torch.io.providers import open_uri
        return open_uri(self, uri, **kw)

    # -- re-streaming cache plumbing (exec/ooc.py's cache tier) ------------

    def _ooc_cache_root(self) -> str:
        """The directory of re-streaming cache entries:
        ``JobConfig.ooc_cache_dir`` (persistent: a restarted job with an
        intact directory skips the cold pass), else a temporary directory
        made on first use and removed when the Context is collected.  A
        remote ``ooc_cache_dir`` (``scheme://``) gets the temporary
        directory too: an entry's sidecar is written with local file
        semantics, and making the URL a local directory would split the
        entry (data remote, sidecar in a literal ``scheme:/`` path)."""
        d = self.config.ooc_cache_dir
        if d and "://" not in d:
            os.makedirs(d, exist_ok=True)
            return d
        root = getattr(self, "_ooc_cache_tmp", None)
        if root is None:
            root = tempfile.mkdtemp(prefix="dryad-ooc-cache-",
                                    dir=self.spill_dir)
            weakref.finalize(self, shutil.rmtree, root, ignore_errors=True)
            self._ooc_cache_tmp = root
        return root

    def _cache_event(self):
        """The sink of the cache's lifecycle events: the Context's event
        log, with the ``dryad_ooc_cache_hits_total`` /
        ``dryad_ooc_cache_writes_total`` counters kept current."""
        from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
        sink = self._event_log

        def ev(e):
            kind = e.get("event")
            if kind in ("ooc_cache_hit", "ooc_cache_write"):
                family_counter(REGISTRY, "ooc_cache_hits"
                               if kind == "ooc_cache_hit"
                               else "ooc_cache_writes").inc()
            if sink is not None:
                sink(e)
        return ev

    def from_store(self, path: str, capacity: int | None = None
                   ) -> "Dataset":
        """Load a store (FromStore), written by this package or the JAX
        one, local, ``s3://`` or ``hdfs://`` (as for ``to_store`` and
        ``read_store_stream``).  Its persisted partitioning is claimed (a
        later group-by or join on those keys skips the exchange) only
        when it has as many
        partitions as this context: re-blocking breaks the placement.  A
        store of at least ``JobConfig.ooc_auto_stream_rows`` rows (when
        set) streams instead (``read_store_stream``)."""
        from dryad_tpu_torch.io.store import read_store, store_meta
        meta = store_meta(path)
        auto = self.config.ooc_auto_stream_rows
        if (auto and self.cluster is None
                and sum(meta.get("counts", [])) >= auto):
            return self.read_store_stream(path)
        pmeta = meta.get("partitioning", {"kind": "none"})
        part = E.Partitioning(pmeta.get("kind", "none"),
                              tuple(pmeta.get("keys", ())))
        if meta["npartitions"] != self.nparts:
            part = E.Partitioning.none()
        if self.cluster is not None:
            from dryad_tpu_torch.runtime.sources import (DeferredSource,
                                                         store_spec)
            spec = store_spec(path, self.nparts, meta, capacity=capacity)
            return Dataset(self, E.Source(parents=(),
                                          data=DeferredSource(spec),
                                          _npartitions=self.nparts,
                                          _partitioning=part))
        pdata = read_store(path, self.mesh, capacity=capacity,
                           verify=self.config.store_verify_checksums)
        return self.from_pdata(pdata, partitioning=part)

    def do_while(self, init: "Dataset",
                 body: Callable[["Dataset"], "Dataset"], n_iters: int,
                 cond: Optional[Callable[[Dict[str, Any]], bool]] = None
                 ) -> "Dataset":
        """Iterative execution (DoWhile), in memory on one process: the
        body is planned ONCE over a placeholder, and each of up to
        ``n_iters`` iterations runs that plan with the previous
        iteration's output bound to it (stages are reused, so a capacity
        scale learned in the first iteration carries over).  The body must
        keep the per-partition capacity (``with_capacity``).  ``cond``, a
        predicate on the current table collected to the host, stops the
        loop early when it returns False.  When tracing, the loop runs in
        a ``loop`` span and each iteration's run in a ``loop.iter`` span.

        On a cluster Context the loop state stays resident on the
        workers under a token (``_cluster_do_while``)."""
        if n_iters > self.config.max_loop_iterations:
            raise ValueError(
                f"n_iters={n_iters} exceeds JobConfig.max_loop_iterations="
                f"{self.config.max_loop_iterations}; raise the knob "
                f"explicitly for longer loops")
        if self.cluster is not None:
            return self._cluster_do_while(init, body, n_iters, cond)
        if self.local_debug:
            cur_host = _oracle.run_oracle(init.node)
            body_node = body(Dataset(self, E.Placeholder(
                parents=(), name="__loop", _npartitions=self.nparts))).node
            for _ in range(n_iters):
                cur_host = _oracle.run_oracle(
                    body_node, bindings={"__loop": cur_host})
                if cond is not None and not cond(cur_host):
                    break
            return Dataset(self, E.Source(parents=(), data=None,
                                          _npartitions=self.nparts,
                                          host=cur_host))
        probe_ph = E.Placeholder(parents=(), name="__loop",
                                 _npartitions=self.nparts, capacity=1)
        if init._streaming() or body(Dataset(self, probe_ph))._streaming():
            # a streamed body: the loop STATE is a small host table
            # (ranks, centroids), and each iteration binds it as an
            # in-memory source and runs the body through the streamed
            # engine, re-reading its streamed inputs from their store or
            # from the re-streaming cache (device working set
            # O(chunk_rows))
            cur_host = init.collect()
            for _ in range(n_iters):
                cur_host = body(self.from_columns(cur_host)).collect()
                if cond is not None and not cond(cur_host):
                    break
            return self.from_columns(cur_host)
        if trace.ACTIVE:
            with trace.scope("loop", "loop",
                             {"iters": n_iters, "planned": 1}) as sp:
                return self._loop_local(init, body, n_iters, cond, sp)
        return self._loop_local(init, body, n_iters, cond)

    def _loop_local(self, init: "Dataset", body, n_iters: int, cond,
                    sp=None) -> "Dataset":
        """The in-memory loop: the init run, the body planned once, one
        Run per iteration (its own deferred settle), each in a
        ``loop.iter`` span when tracing; ``sp``, the ``loop`` span, gets
        the body's stage count and the iterations run."""
        cur = init._materialize()
        ph = E.Placeholder(parents=(), name="__loop",
                           _npartitions=self.nparts, capacity=cur.capacity)
        graph = plan_query(body(Dataset(self, ph)).node, self.nparts,
                           hosts=self.hosts, levels=self.levels)
        if sp is not None:
            sp.set(stages=len(graph.stages))
        done = 0
        for i in range(n_iters):
            if trace.ACTIVE:
                with trace.scope("loop.iter", "loop", {"i": i}):
                    nxt = self.executor.run(graph, bindings={"__loop": cur})
            else:
                nxt = self.executor.run(graph, bindings={"__loop": cur})
            if nxt.capacity != cur.capacity:
                raise ValueError(
                    "do_while body must preserve per-partition capacity "
                    f"({cur.capacity} -> {nxt.capacity}); use explicit "
                    "capacities (with_capacity) inside the loop")
            cur = nxt
            done += 1
            if cond is not None and not cond(pdata_to_host(cur)):
                break
        if sp is not None:
            sp.set(iters_run=done)
        return self.from_pdata(cur)

    def _cluster_do_while(self, init: "Dataset", body, n_iters: int,
                          cond) -> "Dataset":
        """The loop on the gang: the init runs once into a resident
        token, and each iteration submits the body with its placeholder
        bound to that token, keeping the output under it again — only
        the plan and the token cross the driver's socket, never the
        table (the reference's cluster-resident temp outputs read in
        place, DrVertex.h:325-351).  ``cond`` collects the table each
        round (a host predicate).  A loop lost to a gang restart (a dead
        or wedged worker, or a lost token) replays once from the init."""
        import dataclasses as _dcs

        from dryad_tpu_torch.runtime.cluster import (ClusterJobError,
                                                     WorkerFailure)
        from dryad_tpu_torch.runtime.sources import DeferredSource
        ph = E.Placeholder(parents=(), name="__loop",
                           _npartitions=self.nparts)
        body_node = body(Dataset(self, ph)).node

        def subst(node, token, cap):
            if isinstance(node, E.Placeholder) and node.name == "__loop":
                return E.Source(parents=(), data=DeferredSource(
                    {"kind": "resident", "token": token, "capacity": cap}),
                    _npartitions=self.nparts)
            parents = tuple(subst(p, token, cap) for p in node.parents)
            if parents == node.parents:
                return node
            return _dcs.replace(node, parents=parents)

        def run_loop():
            token = self._fresh_token("loop")
            try:
                reply = self._cluster_run(init.node, collect=False,
                                          keep_token=token, want_reply=True)
                cap = reply["resident_capacity"]
                for it in range(n_iters):
                    # the body plan is the same every round: lint it once
                    reply = self._cluster_run(
                        subst(body_node, token, cap),
                        collect=cond is not None, keep_token=token,
                        want_reply=True, lint=it == 0)
                    # a streamed body keeps its output at the gang's
                    # pow2 capacity: the next round reads it at that
                    cap = reply["resident_capacity"]
                    if cond is not None and not cond(reply["table"]):
                        break
                return token, cap
            except BaseException:
                # an abandoned token must not pin its PData on the workers
                self.cluster.pending_release.append(token)
                raise

        try:
            token, cap = run_loop()
        except WorkerFailure:
            token, cap = run_loop()
        except ClusterJobError as e:
            if e.missing_token is None:
                raise
            token, cap = run_loop()
        return self._resident_dataset(token, cap)


class Dataset:
    """A lazy, partitioned, columnar dataset."""

    def __init__(self, ctx: Context, node: E.Node):
        self.ctx = ctx
        self.node = node

    def select(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]],
               label: str = "select") -> "Dataset":
        """Columnwise projection: fn(cols) -> new cols (replaces the
        columns)."""
        return Dataset(self.ctx, E.Map(parents=(self.node,), fn=fn,
                                       label=label))

    def where(self, fn: Callable[[Dict[str, Any]], Any],
              label: str = "where") -> "Dataset":
        """Keep the rows where fn(cols) (a bool [capacity] mask) holds."""
        return Dataset(self.ctx, E.Filter(parents=(self.node,), fn=fn,
                                          label=label))

    def split_words(self, column: str, out_capacity: int,
                    max_token_len: int | None = None,
                    delims: bytes | None = None,
                    lower: bool = False,
                    max_tokens_per_row: int | None = None) -> "Dataset":
        """Tokenizing SelectMany (the WordCount flat-map).  Token length
        and delimiter defaults come from JobConfig."""
        cfg = self.ctx.config
        return Dataset(self.ctx, E.FlatTokens(
            parents=(self.node,), column=column, out_capacity=out_capacity,
            max_token_len=(cfg.token_max_len if max_token_len is None
                           else max_token_len),
            delims=cfg.token_delims if delims is None else delims,
            lower=lower, max_tokens_per_row=max_tokens_per_row))

    def apply_per_partition(self, fn, label: str = "apply",
                            preserves_partitioning: bool = False,
                            host_fn=None) -> "Dataset":
        """``fn(batch) -> Batch`` on every partition (the escape hatch).
        ``fn`` sees the port's Batches: torch tensors on the context's
        device, the count a 0-d int32 tensor.  With
        ``preserves_partitioning`` the input's partitioning claim carries
        over.  ``host_fn(table) -> table`` is the same function on host
        tables, kept with the plan."""
        return Dataset(self.ctx, E.ApplyPerPartition(
            parents=(self.node,), fn=fn, label=label,
            preserves_partitioning=preserves_partitioning, host_fn=host_fn))

    def apply_with_partition_index(self, fn, label: str = "apply_idx"
                                   ) -> "Dataset":
        """``fn(batch, partition_index) -> Batch``; the index is an int in
        [0, nparts)."""
        return Dataset(self.ctx, E.ApplyPerPartition(
            parents=(self.node,), fn=fn, label=label, with_index=True))

    def flat_map(self, fn, out_capacity: int,
                 label: str = "flat_map") -> "Dataset":
        """Generic SelectMany: ``fn(cols) -> (out_cols, mask)`` with every
        output column [capacity, m, ...] and mask [capacity, m] bool; the
        masked cells of the valid rows, flattened row-major, become rows.
        ``out_capacity`` rows per partition; an overflow retries at the
        measured size."""
        return Dataset(self.ctx, E.FlatMap(
            parents=(self.node,), fn=fn, out_capacity=out_capacity,
            label=label))

    def sliding_window(self, w: int) -> "Dataset":
        """Windows of ``w`` consecutive rows in global row order (windows
        crossing the end are dropped); columns gain a window axis
        [rows, w, ...].  Every partition but the last takes its halo from
        the next one, which must hold at least w - 1 rows."""
        return Dataset(self.ctx, E.SlidingWindow(parents=(self.node,), w=w))

    def fork_by(self, fn) -> Tuple["Dataset", "Dataset"]:
        """Split one scan into the rows where ``fn(cols)`` holds and the
        rest; the shared parent is materialized once (Tee)."""
        t = self.where(fn, label="fork_t")
        f = self.where(lambda c, _fn=fn: ~_fn(c), label="fork_f")
        return t, f

    def fork(self, *predicates) -> Tuple["Dataset", ...]:
        """One branch per predicate over a single shared scan (the parent
        is materialized once by the planner's consumer count).  Branches
        may overlap or leave rows out."""
        return tuple(self.where(p, label=f"fork_{i}")
                     for i, p in enumerate(predicates))

    def fork_on(self, column: str, values: Sequence[Any]
                ) -> Tuple["Dataset", ...]:
        """One branch per value: branch i holds the rows where
        ``column == values[i]``."""
        dev = self.ctx.device
        return tuple(
            self.where(lambda c, _v=torch.as_tensor(v, device=dev):
                       c[column] == _v, label=f"fork_{column}_{i}")
            for i, v in enumerate(values))

    def assume_hash_partition(self, keys: Sequence[str]) -> "Dataset":
        """Declare, without moving rows, that each key's rows lie on the
        partition its hash names: a later group-by, group-contents
        operator or join on the same keys skips its exchange."""
        return Dataset(self.ctx, E.AssumePartitioning(
            parents=(self.node,), kind="hash", keys=tuple(keys)))

    def group_by(self, keys: Sequence[str],
                 aggs: Dict[str, Any]) -> "Dataset":
        """GroupBy + decomposable aggregates: aggs maps output column ->
        (kind, value_column), kind in sum/count/min/max/mean/any/all, or
        -> a ``Decomposable(seed, merge, finalize)`` for user-defined
        aggregation.  Groups are identified by a 64-bit key hash, as in
        the JAX package."""
        return Dataset(self.ctx, E.GroupByAgg(
            parents=(self.node,), keys=tuple(keys), aggs=dict(aggs)))

    def hash_partition(self, keys: Sequence[str]) -> "Dataset":
        """Explicit repartition by key hash."""
        return Dataset(self.ctx, E.HashRepartition(parents=(self.node,),
                                                   keys=tuple(keys)))

    def group_top_k(self, keys: Sequence[str], k: int, by: str,
                    descending: bool = True) -> "Dataset":
        """Per-group top-k rows by ``by`` (all columns kept; ties keep
        arrival order)."""
        return Dataset(self.ctx, E.GroupTopK(
            parents=(self.node,), keys=tuple(keys), k=k, by=by,
            descending=descending))

    def group_apply(self, keys: Sequence[str], fn,
                    group_capacity: int, max_groups: int | None = None,
                    out_rows: int = 1, out_capacity: int | None = None
                    ) -> "Dataset":
        """GroupBy yielding each group's CONTENTS to ``fn`` (the general
        result selector: a window function, a mode, any non-decomposable
        reduction).  ``fn(cols, count) -> (out_cols, mask)`` sees one
        group's columns as [group_capacity, ...] tensors (rows >= count
        unspecified: mask by count) and its row count; out_cols are
        [out_rows, ...] and mask [out_rows] bool.  ``fn`` is mapped over
        the groups with ``torch.func.vmap``, so it must be vmap-able (no
        data-dependent Python control flow).  The group keys are attached
        to the output.  ``group_capacity`` bounds one group's rows,
        ``max_groups`` a partition's groups (default: the input capacity),
        ``out_capacity`` the output rows (default: the input capacity); an
        overflow of any retries at the measured size.  The regroup holds
        max_groups x group_capacity cells per column."""
        return Dataset(self.ctx, E.GroupApply(
            parents=(self.node,), keys=tuple(keys), fn=fn,
            group_capacity=group_capacity, max_groups=max_groups,
            out_rows=out_rows, out_capacity=out_capacity))

    def group_median(self, keys: Sequence[str], by: str,
                     out: str | None = None) -> "Dataset":
        """One row per group: keys + the LOWER median of ``by`` (element
        (n-1)//2 of the ascending order — always an element of the
        group, unlike numpy's interpolated even-size median)."""
        return Dataset(self.ctx, E.GroupRankSelect(
            parents=(self.node,), keys=tuple(keys), by=by, rank="median",
            out=out))

    def order_by(self, keys: Sequence[Tuple[str, bool]]) -> "Dataset":
        """Global sort; keys = [(column, descending), ...]."""
        return Dataset(self.ctx, E.OrderBy(parents=(self.node,),
                                           keys=tuple(keys)))

    def distinct(self, keys: Sequence[str] = ()) -> "Dataset":
        """One row per distinct key (by ``keys``, or all columns when
        empty): the first in arrival order.  Keys are told apart by their
        64-bit hash, as in ``group_by``."""
        return Dataset(self.ctx, E.Distinct(parents=(self.node,),
                                            keys=tuple(keys)))

    def range_partition(self, keys: Sequence[str]) -> "Dataset":
        """Explicit repartition by ranges of the first key."""
        return Dataset(self.ctx, E.RangeRepartition(parents=(self.node,),
                                                    keys=tuple(keys)))

    def assume_range_partition(self, keys: Sequence[str]) -> "Dataset":
        """Declare, without moving rows, that partitions hold ascending
        ranges of ``keys``."""
        return Dataset(self.ctx, E.AssumePartitioning(
            parents=(self.node,), kind="range", keys=tuple(keys)))

    def assume_order_by(self, keys: Sequence[str]) -> "Dataset":
        """Declare, without sorting, that the data is globally sorted
        ascending by ``keys`` (AssumeOrderBy).  A later ``order_by`` whose
        ascending keys are a prefix of ``keys`` skips the range exchange
        and only sorts locally."""
        return self.assume_range_partition(keys)

    def take(self, n: int) -> "Dataset":
        """The first ``n`` rows, in partition order."""
        return Dataset(self.ctx, E.Take(parents=(self.node,), n=n))

    def zip_with(self, other: "Dataset", suffix: str = "_r") -> "Dataset":
        """Positional pairing by global row index (LINQ Zip), as many rows
        as the shorter side; ``other``'s columns suffixed on a name clash.
        Sides with different per-partition counts are realigned by an
        exchange."""
        return Dataset(self.ctx, E.Zip(parents=(self.node, other.node),
                                       suffix=suffix))

    def with_row_index(self, column: str = "row_index") -> "Dataset":
        """Add a global int32 row-index column (partition order)."""
        return Dataset(self.ctx, E.WithRowIndex(parents=(self.node,),
                                                column=column))

    def skip(self, n: int) -> "Dataset":
        """Every row but the first ``n``, in partition order."""
        return Dataset(self.ctx, E.SkipTake(parents=(self.node,), op="skip",
                                            n=n))

    def take_while(self, fn) -> "Dataset":
        """The rows before the first one where ``fn(cols)`` (a bool
        [capacity] mask) fails, in partition order."""
        return Dataset(self.ctx, E.SkipTake(parents=(self.node,),
                                            op="take_while", fn=fn))

    def skip_while(self, fn) -> "Dataset":
        """The rows from the first one where ``fn(cols)`` fails on."""
        return Dataset(self.ctx, E.SkipTake(parents=(self.node,),
                                            op="skip_while", fn=fn))

    def with_capacity(self, capacity: int) -> "Dataset":
        """Coerce per-partition capacity (pad; a truncation that would drop
        rows raises CapacityError): keeps do_while bodies shape-stable."""
        return Dataset(self.ctx, E.WithCapacity(parents=(self.node,),
                                                capacity=capacity))

    def cross_apply(self, other: "Dataset", fn, host_fn=None,
                    label: str = "cross_apply") -> "Dataset":
        """``fn(batch, other_batch) -> Batch`` on every partition, with
        ``other`` broadcast to every partition (small data).  ``fn`` sees
        the port's Batches: torch tensors on the context's device, the
        count a 0-d int32 tensor.  ``host_fn(table, other_table)`` is the
        same function on host tables, kept with the plan."""
        return Dataset(self.ctx, E.CrossApply(
            parents=(self.node, other.node), fn=fn, host_fn=host_fn,
            label=label))

    def broadcast(self) -> "Dataset":
        """Replicate to every partition (small datasets)."""
        return Dataset(self.ctx, E.Broadcast(parents=(self.node,)))

    def union(self, other: "Dataset") -> "Dataset":
        """The distinct rows of both (set semantics, all columns)."""
        return Dataset(self.ctx, E.SetOp(parents=(self.node, other.node),
                                         op="union"))

    def intersect(self, other: "Dataset") -> "Dataset":
        """The distinct rows found in both."""
        return Dataset(self.ctx, E.SetOp(parents=(self.node, other.node),
                                         op="intersect"))

    def except_(self, other: "Dataset") -> "Dataset":
        """The distinct rows of this dataset not found in ``other``."""
        return Dataset(self.ctx, E.SetOp(parents=(self.node, other.node),
                                         op="except"))

    def concat(self, other: "Dataset") -> "Dataset":
        """Every row of both (a multiset), partition by partition."""
        return Dataset(self.ctx, E.Concat(parents=(self.node, other.node)))

    def aggregate(self, dec: "E.Decomposable"):
        """Whole-dataset user-defined aggregation: the decomposable
        protocol over ONE global group (a const-key ``group_by``); returns
        the finalized value, or a dict of them for a dict finalize."""
        const = self.select(_add_agg_key, label="agg-key")
        out = const.group_by(["__agg_key"], {"agg": dec}).collect()
        res = {k: v for k, v in out.items() if k != "__agg_key"}
        if set(res) == {"agg"}:
            return _first_if_one(res["agg"])
        return {k: _first_if_one(v) for k, v in res.items()}

    def join(self, other: "Dataset", left_keys: Sequence[str],
             right_keys: Sequence[str] | None = None,
             expansion: float | None = None, broadcast: bool = False,
             how: str = "inner", right_unique: bool = False) -> "Dataset":
        """Equi-join on ``left_keys`` = ``right_keys``; output columns =
        left columns + right non-key columns (suffixed ``_r`` on a name
        clash), ``expansion`` x the left capacity per partition.
        ``how="left"`` keeps unmatched left rows with the right columns
        zero-filled; ``how="right"`` keeps unmatched right rows, their
        keys in the left key columns and the other left columns
        zero-filled; ``how="full"`` keeps both.  ``right_unique=True``
        declares the right side unique-keyed (a lookup table) and routes
        an inner or left join through the merge-fill join; uniqueness is
        checked at run time and duplicates take the general join.
        ``broadcast=True`` (or ``JobConfig.broadcast_join_threshold``)
        replicates the right side to every partition instead of
        hash-exchanging both; the output
        then keeps the left side's placement (a right or full join never
        broadcasts: its unmatched right rows would come out once per
        partition).  A hash join whose exchanges overflow on a hot key
        re-runs with the salted exchange, unless a later stage relies on
        its placement."""
        if how not in ("inner", "left", "right", "full"):
            raise ValueError(f"unknown join how={how!r}")
        return Dataset(self.ctx, E.Join(
            parents=(self.node, other.node), left_keys=tuple(left_keys),
            right_keys=tuple(right_keys or left_keys),
            expansion=expansion or self.ctx.config.join_expansion,
            broadcast_right=broadcast, how=how,
            right_unique=right_unique))

    def group_join(self, other: "Dataset", left_keys: Sequence[str],
                   aggs: Dict[str, Any],
                   right_keys: Sequence[str] | None = None,
                   expansion: float = 1.0) -> "Dataset":
        """GroupJoin: each left row with the AGGREGATE of its matching
        right group: ``other.group_by(right_keys, aggs)`` then a left join,
        so a left row without a group gets zero aggregates (include a
        ``("count", None)`` to tell empty groups apart)."""
        rkeys = list(right_keys or left_keys)
        return self.join(other.group_by(rkeys, aggs), left_keys, rkeys,
                         expansion=expansion, how="left")

    def cache(self) -> "Dataset":
        """Materialize NOW and reuse the result in later queries (hoist
        loop-invariant work out of a do_while body).

        In memory the result stays on the card and keeps its
        partitioning claim; a run that salted a join, or whose adaptive
        rewrites flipped a join's broadcast, drops the claim (its rows no
        longer lie where the key's hash says).  Streamed data, and
        in-memory data of edge scale (DTA204: more than a fraction of
        ``JobConfig.device_hbm_bytes``), take the store-backed
        RE-STREAMING tier (``JobConfig.ooc_restream_cache``, default on):
        the cold pass writes a local chunked store keyed by the query's
        stable fingerprint (``ooc_cache_write``), and every later pass,
        or a new process with the same ``ooc_cache_dir``, re-streams it
        (``ooc_cache_hit``); a corrupt or stale entry falls back to a
        clean re-stream of the query, never wrong rows.  With the tier
        off, streamed data is spooled once to an unvalidated temporary
        store.  Under ``local_debug`` the oracle's table is cached on the
        host.  On a cluster Context the result stays resident on the
        workers under a token, keeping its partitioning claim (dropped
        when a stage ran salted), and heals after a gang restart by
        re-running this query; streamed or edge-scale data instead takes
        the re-streaming tier on the gang (``_cache_restream_cluster``)."""
        if self.ctx.local_debug:
            return Dataset(self.ctx, E.Source(
                parents=(), data=None, _npartitions=self.ctx.nparts,
                host=_oracle.run_oracle(self.node)))
        cfg = self.ctx.config
        if self.ctx.cluster is not None:
            if cfg.ooc_restream_cache and not self._stream_sourced():
                diag = self._cache_cost_diag()
                edge = diag is not None and diag.severity == "info"
            else:
                edge = False
            if cfg.ooc_restream_cache and (self._stream_sourced() or edge):
                return self._cache_restream_cluster()
            token = self.ctx._fresh_token("cache")
            reply = self.ctx._cluster_run(self.node, collect=False,
                                          keep_token=token, want_reply=True)
            return self.ctx._resident_dataset(
                token, reply["resident_capacity"],
                partitioning=(E.Partitioning.none() if reply.get("salted")
                              else self.node.partitioning),
                producer=self.node)
        if self._streaming():
            if cfg.ooc_restream_cache:
                return self._cache_restream_local()
            d = tempfile.mkdtemp(prefix="dryad-cache-",
                                 dir=self.ctx.spill_dir)
            weakref.finalize(self.ctx, shutil.rmtree, d, ignore_errors=True)
            self.to_store(d + "/data")
            return self.ctx.read_store_stream(d + "/data")
        diag = self._cache_cost_diag()
        if diag is not None and diag.severity == "info":
            # edge-scale: a local store instead of device memory, streamed
            # by later queries
            return self._cache_restream_inmem()
        return self._job("cache", self._cache_local)

    def _cache_local(self) -> "Dataset":
        """The in-memory ``cache()``: the run, then its output as a
        source (in a ``cache`` span when tracing)."""
        pd, salted = self._run()
        part = E.Partitioning.none() if salted else self.node.partitioning
        if trace.ACTIVE:
            with trace.scope("cache", "terminal"):
                return self.ctx.from_pdata(pd, partitioning=part)
        return self.ctx.from_pdata(pd, partitioning=part)

    def _cache_cost_diag(self):
        """The DTA204 finding for caching this query (None when it is not
        edge-scale, the budget is unknown or the tier is off, when
        nothing would act on it).  Best effort: a cost-model failure
        never blocks a cache()."""
        cfg = self.ctx.config
        if not cfg.device_hbm_bytes or not cfg.ooc_restream_cache:
            return None
        try:
            from dryad_tpu_torch.analysis.cost import cache_diagnostic
            return cache_diagnostic(self.cost(), cfg)
        except Exception:
            return None

    def _stream_sourced(self) -> bool:
        """Does any source stream: a local ``StreamSource`` or a cluster
        ``store_stream`` spec (the streamed half of the re-streaming
        tier's test)?"""
        from dryad_tpu_torch.analysis.plan_rules import _is_stream_source
        return any(isinstance(n, E.Source) and n.data is not None
                   and _is_stream_source(n.data)
                   for n in E.walk(self.node))

    def _cache_restream_cluster(self) -> "Dataset":
        """Cluster ``cache()`` of streamed or edge-scale data: the gang
        writes the entry's data store in parallel (one writer a worker)
        instead of pinning a dataset-sized resident, and later queries
        stream it.  The root must be a local or shared filesystem the
        workers reach: ``ooc_cache_dir``, else
        ``cluster_stream_spool_dir``, else the Context's temporary root
        (a one-machine cluster); a remote root has no sidecar file
        semantics and takes the temporary root too."""
        from dryad_tpu_torch.exec import ooc
        cfg = self.ctx.config
        root = cfg.ooc_cache_dir or cfg.cluster_stream_spool_dir
        if root is None or "://" in root:
            root = self.ctx._ooc_cache_root()
        else:
            os.makedirs(root, exist_ok=True)
        key = _stable_node_fp(self.node)
        ev = self.ctx._cache_event()
        entry, data, _side = ooc.cache_entry_paths(root, key)
        warm = ooc.cached_chunk_source(root, key)
        if warm is None:
            os.makedirs(entry, exist_ok=True)
            part = self.node.partitioning
            self.ctx._cluster_run(
                self.node, collect=False, store_path=data,
                store_partitioning={"kind": part.kind,
                                    "keys": list(part.keys)})
            sc = ooc.adopt_chunk_cache(root, key, cfg.ooc_chunk_rows)
            ev({"event": "ooc_cache_write", "path": entry,
                "rows": sc["rows"], "bytes": sc["bytes"]})
        else:
            sc = warm[1]
            ev({"event": "ooc_cache_hit", "path": entry,
                "rows": sc.get("rows"), "bytes": sc.get("bytes")})
        return self.ctx.read_store_stream(
            data, chunk_rows=int(sc["chunk_rows"]))

    def _cache_restream_local(self) -> "Dataset":
        """Streamed cache(): the fingerprinted local chunk cache.  The
        cold pass runs the query through the streamed engine once,
        writing the entry; a warm entry (a new process with an intact
        ``ooc_cache_dir`` too) skips it, and every later pass re-streams
        local sequential reads."""
        from dryad_tpu_torch.exec import ooc
        root = self.ctx._ooc_cache_root()
        key = _stable_node_fp(self.node)
        ev = self.ctx._cache_event()
        warm = ooc.cached_chunk_source(root, key)
        if warm is None:
            cs = self._stream_run()
            sc = ooc.write_chunk_cache(root, key, cs)
            ev({"event": "ooc_cache_write",
                "path": ooc.cache_entry_paths(root, key)[0],
                "rows": sc["rows"], "bytes": sc["bytes"]})
            chunk_rows, schema = sc["chunk_rows"], cs.schema
        else:
            chunk_rows = int(warm[1]["chunk_rows"])
            schema = warm[0].schema
        return self.ctx.from_stream(ooc.cache_source(
            root, key, chunk_rows, schema, make_producer=self._stream_run,
            on_event=ev))

    def _cache_restream_inmem(self) -> "Dataset":
        """Edge-scale in-memory cache(): materialize once into a local
        store (``to_store``, per-partition checksums) and hand back a
        streamed read of it: the result no longer pins the card for the
        Context's lifetime."""
        from dryad_tpu_torch.exec import ooc
        cfg = self.ctx.config
        root = self.ctx._ooc_cache_root()
        key = _stable_node_fp(self.node)
        ev = self.ctx._cache_event()
        warm = ooc.cached_chunk_source(root, key)
        if warm is None:
            entry, data, _side = ooc.cache_entry_paths(root, key)
            os.makedirs(entry, exist_ok=True)
            self.to_store(data)
            sc = ooc.adopt_chunk_cache(root, key, cfg.ooc_chunk_rows)
            ev({"event": "ooc_cache_write", "path": entry,
                "rows": sc["rows"], "bytes": sc["bytes"]})
            warm = ooc.cached_chunk_source(root, key)
        chunk_rows = int(warm[1]["chunk_rows"])

        def producer():
            # after a mid-stream invalidation: materialize in memory
            # again (it fit on the card) and cut it into chunks
            from dryad_tpu_torch.exec.stream_exec import _resolve_source
            return _resolve_source(self._materialize(), cfg)

        return self.ctx.from_stream(ooc.cache_source(
            root, key, chunk_rows, warm[0].schema, make_producer=producer,
            on_event=ev))

    def _streaming(self) -> bool:
        """Does any source of the query stream?"""
        from dryad_tpu_torch.exec.stream_exec import StreamSource
        return any(isinstance(n, E.Source) and isinstance(n.data,
                                                          StreamSource)
                   for n in E.walk(self.node))

    def _stream_run(self):
        """Plan with ONE logical partition and run over chunk streams on
        the context's device (``exec/stream_exec.py``); returns the lazy
        output ChunkSource."""
        from dryad_tpu_torch.exec.stream_exec import run_stream_graph
        graph = plan_query(self.node, 1, hosts=1, config=self.ctx.config)
        self.ctx._pre_submit_lint(self.node, graph=graph)
        return run_stream_graph(graph, self.ctx.config, self.ctx.device,
                                spill_dir=self.ctx.spill_dir,
                                event_log=self.ctx.executor._event)

    def plan(self):
        return plan_query(self.node, self.ctx.nparts, hosts=self.ctx.hosts,
                          levels=self.ctx.levels, config=self.ctx.config)

    def cost(self):
        """The static cost model's report (``analysis.cost.CostReport``)
        for the plan a terminal call would run: per-stage row intervals,
        exact output bytes, per-partition working-set bounds.  Runs
        nothing and allocates nothing on the card."""
        from dryad_tpu_torch.analysis.cost import estimate_query
        return estimate_query(self.node, self.ctx.nparts,
                              hosts=self.ctx.hosts, levels=self.ctx.levels,
                              config=self.ctx.config)

    def _job(self, terminal: str, fn, *args):
        """``fn(*args)``, an in-process terminal's run and its own work on
        the output, inside the job's ``query`` root span when tracing."""
        if trace.ACTIVE:
            with trace.scope("query", "query", {"terminal": terminal}):
                return fn(*args)
        return fn(*args)

    def _planned(self):
        """(the stage graph, the lint's cost report)."""
        graph = self.plan()
        return graph, self.ctx._pre_submit_lint(self.node, graph=graph)

    def _run(self):
        """(output, whether the output's placement left the plan's: a
        stage ran salted, or an adaptive rewrite flipped a join's
        broadcast).  The planning runs in a ``plan`` span when
        tracing."""
        if trace.ACTIVE:
            with trace.scope("plan", "plan") as sp:
                graph, cost_rep = self._planned()
                sp.set(stages=len(graph.stages))
        else:
            graph, cost_rep = self._planned()
        ex = self.ctx.executor
        # this query's own run: another run on the same executor (a
        # service fleet thread) must not decide this output's placement
        runs = []
        out = ex.run(graph, spill_dir=self.ctx.spill_dir,
                     cost_report=cost_rep, runs=runs)
        return out, (any(st._salted for st in graph.stages)
                     or runs[0].placement_changed)

    def _materialize(self):
        return self._run()[0]

    def collect(self) -> Dict[str, Any]:
        """Execute and pull all rows to the host (on a cluster Context the
        parallel collect: each worker ships its own partitions' rows)."""
        if self.ctx.local_debug:
            return _oracle.run_oracle(self.node)
        if self.ctx.cluster is not None:
            out = self.ctx._cluster_run(self.node)
        elif self._streaming():
            from dryad_tpu_torch.exec.stream_exec import chunks_to_table
            out = chunks_to_table(self._stream_run())
        else:
            out = self._job("collect", self._collect_local)
        if isinstance(self.node, E.Take):
            out = {k: v[:self.node.n] for k, v in out.items()}
        return out

    def _collect_local(self) -> Dict[str, Any]:
        """The in-process collect: the run, then the shrink and the copy
        to the host (in a ``collect`` span when tracing)."""
        pd = self._materialize()
        if trace.ACTIVE:
            with trace.scope("collect", "terminal"):
                return pdata_to_host(maybe_shrink_for_collect(
                    pd, self.ctx.config))
        return pdata_to_host(maybe_shrink_for_collect(pd, self.ctx.config))

    def to_store(self, path: str, compression: str | None = None) -> None:
        """Execute and persist as a store (ToStore) at a local,
        ``s3://`` or ``hdfs://`` path (a streamed dataset: local or
        ``hdfs://``), with this dataset's partitioning claim (dropped
        where ``cache`` drops it).
        ``compression="gzip"`` (default ``JobConfig.store_compression``)
        writes level-1 gzip part files.  On a cluster Context the
        parallel output: each worker writes its own partitions, and
        worker 0 commits the meta (a shared local path)."""
        if compression is None:
            compression = self.ctx.config.store_compression
        if compression not in (None, "gzip"):
            raise ValueError(f"unknown compression {compression!r}")
        if self.ctx.cluster is not None:
            part = self.node.partitioning
            self.ctx._cluster_run(
                self.node, collect=False, store_path=path,
                store_partitioning={"kind": part.kind,
                                    "keys": list(part.keys)},
                store_compression=compression)
            return
        if self._streaming():
            # one partition file per output chunk, written as the chunks
            # come
            from dryad_tpu_torch.exec.ooc import write_chunks_to_store
            part = self.node.partitioning
            cs = self._stream_run()
            write_chunks_to_store(
                path, iter(cs), cs.schema,
                partitioning={"kind": part.kind, "keys": list(part.keys)},
                compression=compression)
            return
        self._job("to_store", self._store_local, path, compression)

    def _store_local(self, path: str, compression) -> None:
        from dryad_tpu_torch.io.store import write_store
        pd, salted = self._run()
        part = E.Partitioning.none() if salted else self.node.partitioning
        write_store(path, pd, partitioning={"kind": part.kind,
                                            "keys": list(part.keys)},
                    compression=compression)

    # -- static analysis ---------------------------------------------------

    def check(self, cluster: bool = False, cost: bool = False):
        """Statically verify this query — plan rules + UDF determinism /
        shippability lint — WITHOUT executing anything.  Returns an
        ``analysis.DiagnosticReport`` with every finding at once (stable
        DTA0xx / DTA1xx codes, source spans).  ``cluster`` turns the
        cluster-shipping rules on (a cluster Context's submissions run
        them; off by default).  ``cost=True`` adds the DTA2xx resource
        findings (the cost model runs the ops on meta tensors: nothing on
        the card)."""
        from dryad_tpu_torch.analysis import check_plan
        report = check_plan(self.node, cluster=cluster,
                            fn_table=self.ctx.fn_table)
        if cost:
            from dryad_tpu_torch.analysis.cost import cost_diagnostics
            report.diagnostics.extend(
                cost_diagnostics(self.cost(), self.ctx.config))
            report.dedup()
        return report

    def analyze(self):
        """EXPLAIN ANALYZE: run this query ONCE under an explicit event
        capture (an ``EventLog(level=2)`` of its own, whatever
        ``DRYAD_LOGGING_LEVEL`` says) and return the measured per-stage
        actuals against the static cost model
        (``obs.analyze.AnalyzeReport``: rows, output bytes, wall and
        compile split, retries, replays, spills, adaptive rewrites, and
        predicted-vs-actual verdicts with the runtime cross-check's
        ``cost_model_miss`` inline).

        The pre-submit lint gate applies as in ``collect()`` (a
        ``lint="error"`` refusal raises LintError here too); with
        ``lint="off"`` the cost pass still runs for the predictions, and
        its failure leaves the report with actuals only.  A context with
        an event log records the report there (``analyze_report``).
        In-memory execution only: local_debug and streamed plans raise
        ValueError (record a JSONL and use ``python -m
        dryad_tpu_torch.obs analyze`` instead)."""
        if self.ctx.cluster is not None:
            raise ValueError(
                "EXPLAIN ANALYZE needs an in-process Context: a cluster "
                "Context's jobs run on the workers — record a JSONL and "
                "use `python -m dryad_tpu_torch.obs analyze` instead")
        if self.ctx.local_debug:
            raise ValueError(
                "EXPLAIN ANALYZE needs the executor: a local_debug context "
                "runs the oracle — record a JSONL and use `python -m "
                "dryad_tpu_torch.obs analyze` instead")
        if self._streaming():
            raise ValueError(
                "EXPLAIN ANALYZE does not cover streamed (>RAM) plans — "
                "per-stage device actuals do not apply; use `python -m "
                "dryad_tpu_torch.obs analyze` over the recorded stream")
        from dryad_tpu_torch.obs.analyze import analyze_events
        from dryad_tpu_torch.utils.events import EventLog
        graph = self.plan()
        # the gate _run runs: "error" findings refuse to submit, "warn"
        # logs them to the context's log; its cost pass feeds the report
        cost_rep = self.ctx._pre_submit_lint(self.node, graph=graph)
        cap = EventLog(level=2)
        if cost_rep is None:
            # lint="off": the report still wants predictions, but the
            # model never blocks ANALYZE (the cost model raises
            # NotImplementedError on an op it cannot shape)
            from dryad_tpu_torch.analysis.cost import estimate_graph
            try:
                cost_rep = estimate_graph(graph, self.ctx.nparts,
                                          config=self.ctx.config)
            except (NotImplementedError, ValueError, TypeError,
                    RuntimeError):
                cost_rep = None
        if cost_rep is not None:
            cap({"event": "cost_report", "report": cost_rep.to_payload()})
        self.ctx.executor.run(graph, spill_dir=self.ctx.spill_dir,
                              cost_report=cost_rep, event_log=cap)
        cap.close()
        rep = analyze_events(cap.events)
        if self.ctx._event_log is not None:
            self.ctx._event_log({"event": "analyze_report",
                                 "report": rep.to_payload()})
        return rep

    def explain(self, verify: bool = False, cost: bool = False,
                analyze: bool = False) -> str:
        """The plan as text; ``verify`` appends the diagnostics of
        ``check()``, ``cost`` the static cost table (with its DTA2xx
        findings among the diagnostics).  Runs nothing, but with
        ``analyze``, which runs the query once and appends its measured
        actuals (``analyze()``)."""
        text = self.plan().explain()
        cost_rep = self.cost() if cost else None
        if verify:
            report = self.check()
            if cost_rep is not None:
                from dryad_tpu_torch.analysis.cost import cost_diagnostics
                report.diagnostics.extend(
                    cost_diagnostics(cost_rep, self.ctx.config))
                report.dedup()
            text += "\n\ndiagnostics:\n" + report.render()
        if cost_rep is not None:
            text += "\n\npredicted cost:\n" + cost_rep.render()
        if analyze:
            text += ("\n\nEXPLAIN ANALYZE (executed):\n"
                     + self.analyze().render())
        return text

    # -- terminal scalars --------------------------------------------------

    def count(self) -> int:
        if self.ctx.local_debug:
            t = _oracle.run_oracle(self.node)
            return len(next(iter(t.values()), ()))
        if self.ctx.cluster is not None:
            # the counts only: no row crosses the control plane
            return self.ctx._cluster_run(self.node, collect="count")
        if self._streaming():
            return sum(c.n for c in self._stream_run())
        return self._job("count", self._count_local)

    def _count_local(self) -> int:
        return int(self._materialize().counts.sum())

    def _scalar(self, kind: str, column: str):
        """A terminal scalar aggregate: per-partition partials on the
        device (``scalar_aggregate``), combined on the host as the JAX
        package does: min / max over the non-empty partitions, the mean
        weighted by the counts, None for an empty dataset.  Under
        ``local_debug``, the oracle's aggregate of the column.  On a
        cluster Context a constant-key group-by ships, so ONE aggregated
        row crosses the control plane."""
        if self.ctx.local_debug:
            t = _oracle.run_oracle(self.node)
            return _oracle._agg(kind, list(t[column]))
        if self.ctx.cluster is not None:
            const = self.select(_add_agg_key, label="agg-key")
            agg = E.GroupByAgg(parents=(const.node,), keys=("__agg_key",),
                               aggs={"out": (kind, column)})
            v = np.asarray(self.ctx._cluster_run(agg)["out"])
            return v[0] if v.shape and v.shape[0] == 1 else v
        if self._streaming():
            # per-chunk host reductions, combined as they come
            from dryad_tpu_torch.exec.stream_exec import stream_scalar
            return stream_scalar(self._stream_run(), kind, column)
        return self._job(kind, self._scalar_local, kind, column)

    def _scalar_local(self, kind: str, column: str):
        """The in-process scalar: per-partition partials of the run's
        output, combined on the host."""
        pd = self._materialize()
        parts = [scalar_aggregate(b, {"out": (kind, column),
                                      "cnt": ("count", None)})
                 for b in split_partitions(pd)]
        vals = torch.stack([p["out"] for p in parts]).cpu().numpy()
        cnts = torch.stack([p["cnt"] for p in parts]).cpu().numpy()
        nonempty = cnts > 0
        if kind == "sum":
            return vals.sum(axis=0)
        if kind == "min":
            return vals[nonempty].min(axis=0) if nonempty.any() else None
        if kind == "max":
            return vals[nonempty].max(axis=0) if nonempty.any() else None
        if kind == "mean":
            total = cnts.sum()
            if total == 0:
                return None
            return (vals.T * cnts).T.sum(axis=0) / total
        if kind == "any":
            return bool(vals[nonempty].any())
        if kind == "all":
            return bool(vals[nonempty].all()) if nonempty.any() else True
        raise ValueError(kind)

    def sum(self, column: str):
        return self._scalar("sum", column)

    def min(self, column: str):
        return self._scalar("min", column)

    def max(self, column: str):
        return self._scalar("max", column)

    def mean(self, column: str):
        return self._scalar("mean", column)

    def any(self, column: str) -> bool:
        return self._scalar("any", column)

    def all(self, column: str) -> bool:
        return self._scalar("all", column)

    def first(self) -> Dict[str, Any]:
        t = self.take(1).collect()
        return {k: v[0] for k, v in t.items()}
