"""The SPMD job body every gang worker runs for one submitted query — the
port of ``dryad_tpu/runtime/exec_common.py``.

Mirrored determinism is the correctness contract: every worker rebuilds
the same graph from the same JSON, runs the same stages in the same
order, and reads the same all-reduced NEEDs, range bounds and slot
probes (``parallel/mesh.py``'s collectives), so every worker takes the
same capacity-retry, salting and slot decisions.  The only coupling
across processes is the gang's host-staged gloo collectives (the data
plane) and the driver's control messages.

Each worker's mesh holds its own ``local_nparts`` of the gang's
``nparts`` partitions; a worker keeps one persistent executor for it
(its slot feedback and probe caches carry over from job to job, as an
iterative query re-submits the same body plan) and a cache of
cluster-resident intermediates (``cache()``, a ``do_while``'s loop
state), keyed by token and dropped by the driver's piggybacked
``release`` lists or by a gang restart (fresh processes).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["execute_plan"]

_EXECUTORS: Dict[Any, Any] = {}
# cluster-resident intermediates: token -> PData
_RESIDENT: Dict[str, Any] = {}


def _gang_executor(mesh, config=None):
    """The worker's persistent executor on ``mesh``, re-pointed at the
    job's JobConfig (the single point where a shipped config applies)."""
    from dryad_tpu_torch.exec.executor import Executor
    ex = _EXECUTORS.get(mesh)
    if ex is None:
        ex = _EXECUTORS[mesh] = Executor(mesh)
    ex.apply_config(config)
    return ex


def execute_plan(plan_json: str, fn_table: Dict[str, Callable],
                 source_specs: Dict[str, Dict[str, Any]], mesh,
                 event_log: Optional[Callable[[dict], None]] = None,
                 store_path: Optional[str] = None,
                 store_partitioning: Optional[Dict[str, Any]] = None,
                 collect: Any = True, config=None,
                 keep_token: Optional[str] = None,
                 release: tuple = (),
                 store_compression: Optional[str] = None) -> Any:
    """Build this worker's partitions of the sources, run the graph, and
    return ``(table, extras)``.  ``collect``: True = this worker's rows
    (the parallel collect: the driver concatenates the parts in worker
    order, which is partition order; the shrink decision reads every
    partition's count, so every worker shrinks alike), ``"count"`` = the
    gang's total row count (one all-gather of the counts), False =
    nothing.  ``store_path`` writes the output as a store, each worker
    its own partitions (``runtime/stream_cluster._write_partitions``).
    ``keep_token`` keeps the output resident under that token;
    ``release`` drops tokens no longer referenced.

    A plan over streamed sources (``store_stream`` specs) runs through
    ``runtime/stream_plan.execute_stream_plan`` instead.

    ``extras``: the run's ``stage_log``, ``salted`` when a stage ran
    salted or an adaptive rewrite moved the output's placement (a
    persisted partitioning claim is then dropped), ``resident_capacity``
    with ``keep_token``, and ``graph_rewrites``."""
    from dryad_tpu_torch.exec.data import (maybe_shrink_for_collect,
                                           pdata_to_host)
    from dryad_tpu_torch.plan.serialize import graph_from_json
    from dryad_tpu_torch.runtime.sources import build_source
    from dryad_tpu_torch.runtime.stream_plan import (execute_stream_plan,
                                                     has_stream_sources)

    if has_stream_sources(source_specs):
        # sources larger than the card: the SAME plan runs as chunk waves
        # and per-partition bucket streams (runtime/stream_plan.py) — one
        # lowering, two execution regimes (channelinterface.h:212)
        return execute_stream_plan(
            plan_json, fn_table, source_specs, mesh, event_log=event_log,
            store_path=store_path, store_partitioning=store_partitioning,
            collect=collect, config=config, keep_token=keep_token,
            release=release, store_compression=store_compression)
    for tok in release:
        _RESIDENT.pop(tok, None)
    ex = _gang_executor(mesh, config)
    verify = ex.config.store_verify_checksums
    sources = {key: build_source(spec, mesh, verify=verify,
                                 resident=_RESIDENT)
               for key, spec in source_specs.items()}
    graph = graph_from_json(plan_json, fn_table=fn_table, sources=sources)
    runs: list = []
    pd = ex.run(graph, event_log=event_log, runs=runs)

    # this worker's stage log (mirrored: every worker's holds the same
    # decisions), for the driver's diagnosis
    extras: Dict[str, Any] = {"stage_log": runs[0].stage_log}
    if runs[0].rewrites:
        extras["graph_rewrites"] = runs[0].rewrites
    # salting decisions are mirrored (all-reduced info vectors), so every
    # worker computes the same flag
    if any(st._salted for st in graph.stages) or runs[0].placement_changed:
        extras["salted"] = True
        if store_partitioning:
            store_partitioning = {"kind": "none"}
    if keep_token is not None:
        _RESIDENT[keep_token] = pd
        extras["resident_capacity"] = pd.capacity

    table = None
    if collect == "count":
        table = int(mesh.gather_parts(pd.counts).sum())
    elif collect:
        table = pdata_to_host(maybe_shrink_for_collect(pd, ex.config,
                                                       mesh))
    if store_path is not None:
        from dryad_tpu_torch.io.store import pdata_schema
        from dryad_tpu_torch.runtime.stream_cluster import (
            _read_local_shards, _write_partitions, local_batch_chunks)
        cols, counts = _read_local_shards(pd)
        start = mesh.part_start
        _write_partitions(store_path, pdata_schema(pd),
                          local_batch_chunks(cols, counts),
                          list(range(start, start + mesh.local_nparts)),
                          mesh, partitioning=store_partitioning,
                          compression=store_compression,
                          capacity=pd.capacity)
    return table, extras
