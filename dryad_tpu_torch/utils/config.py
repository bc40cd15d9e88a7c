"""Job configuration — the subset of ``dryad_tpu/utils/config.JobConfig``
that the port's ported paths read.  Field names and defaults match the
JAX package, so one set of overrides means the same thing to both."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from dryad_tpu_torch.adapt.thresholds import \
    SKEW_SIBLING_MEDIAN_FACTOR as _SKEW_FACTOR

__all__ = ["JobConfig"]


@dataclasses.dataclass(frozen=True)
class JobConfig:
    # -- executor: capacity management (exec/executor.py) ------------------
    # retries after the first overflow; each retry is right-sized from the
    # measured need
    max_capacity_retries: int = 3
    # initial send-slot slack factor for exchanges (C = ceil(slack*cap/D))
    initial_send_slack: int = 2
    # measured send slots: a pure hash repartition leg (no ops) whose
    # input holds at least this many MB runs a counts-only probe first,
    # so its first attempt ships the measured slot instead of the
    # structural slack; later runs of a stage ship the slot the last one
    # measured.  -1 disables both; 0 always probes
    exchange_probe_min_mb: float = 8.0
    # range exchange split points: ordering lanes sampled per partition
    # (evenly spread over its valid rows) before the bounds are picked
    range_samples_per_partition: int = 4096
    # hot-key salting (exec/executor.py + parallel/shuffle.py
    # skew_join_exchange): a saltable join stage switches to the salted
    # exchange when a retry would need >= trigger x the current
    # per-destination capacity
    salt_trigger_factor: int = 4
    # a key is hot when its global row count exceeds factor x (rows / P)
    salt_hot_factor: float = 4.0
    # per-partition heavy-hitter candidates nominated for the hot set
    salt_topk: int = 8
    # optimistic stage execution (exec/recovery.Run._settle): stages run
    # with no per-stage host read of their needs; every stage's needs are
    # read back in ONE batched read at job end, and an overflow replays
    # the overflowed stages and their dependents synchronously
    deferred_needs: bool = True

    # -- adaptive execution (adapt/) ---------------------------------------
    # stage-boundary graph rewriting from measured per-partition rows (the
    # connection managers of adapt/rules.py).  "off": nothing is built and
    # the plan runs as planned.  "on": the not-yet-executed stages may be
    # rewritten after each stage materializes; that needs each stage's
    # rows on the host, so the run takes the synchronous path (no
    # deferred settle)
    adaptive: str = "off"
    # a partition is skewed at >= this multiple of its sibling median
    # (adapt/thresholds.py)
    adapt_skew_factor: float = _SKEW_FACTOR
    # collapse a hierarchical aggregation tree to one global exchange at
    # most this many measured upstream rows
    adapt_agg_collapse_rows: int = 4096
    # expand a flat merge into per-axis hops (multi-level meshes) from
    # this many measured upstream rows
    adapt_agg_expand_rows: int = 1 << 20
    # shrink a downstream exchange's capacity when it exceeds this
    # multiple of the measured row bound
    adapt_shrink_factor: float = 2.0
    # a broadcast join's measured build side must stay within this
    # fraction of the probe side's rows: above it a planned broadcast
    # demotes to hash exchanges, below it a saltable hash join promotes
    adapt_broadcast_max_ratio: float = 0.25

    # -- pre-submit static analysis (analysis/) ----------------------------
    # gate every in-memory and streamed submission through the plan
    # verifier and the UDF lint: "off" = no checking, "warn" = run the
    # job and log the findings (``lint_finding`` events, with the cost
    # pass's ``cost_report``), "error" = refuse to submit when
    # error-severity findings exist (analysis.LintError).
    # ``Dataset.check()`` is the interactive form.
    lint: str = "off"

    # -- static cost model (analysis/cost.py) ------------------------------
    # per-device memory budget the DTA2xx findings compare the predicted
    # working set with; 0 = unknown (no budget finding)
    device_hbm_bytes: int = 0

    # -- fault tolerance (exec/recovery.py) --------------------------------
    # lineage replays allowed before FailureBudgetExceeded
    failure_budget: int = 16
    # spilled stage outputs: None = raw part files, "gzip" = level-1 gzip
    spill_compression: Optional[str] = None

    # -- observability (obs/) ---------------------------------------------
    # device-time profiling: when set, every executor run is wrapped in a
    # torch.profiler trace (host and CUDA activity) written under this
    # directory as Chrome trace JSON (open in Perfetto)
    profile_dir: Optional[str] = None
    # background resource sampler period (obs/profile.py): a Run emits
    # periodic resource_sample events (RSS, CPU%, the device's allocated
    # bytes, gc counts; level 2) while it computes.  0 disables.  The
    # sampler only runs when an event consumer at level 2 exists (the
    # same no-consumer-no-work contract as spans)
    resource_sample_s: float = 0.5
    # where a job's failure forensics bundles land (obs/flight.py): the
    # job service sets its job's bundles/ directory here (service/job.py)
    forensics_dir: Optional[str] = None
    # job history archive (obs/history.py): when set, the Context's
    # EventLog snapshots {events, plan, metrics} here on close; browse
    # with `python -m dryad_tpu_torch.obs history <dir>`
    history_dir: Optional[str] = None

    # -- cluster runtime (runtime/cluster.py) ------------------------------
    cluster_processes: int = 2
    cluster_devices_per_process: int = 2
    cluster_startup_timeout_s: float = 180.0
    cluster_job_timeout_s: float = 600.0
    cluster_fn_modules: Tuple[str, ...] = ()
    # the gang's straggler / wedge watchdog (runtime/cluster.py): an SPMD
    # gang cannot duplicate one member, so a wedged worker tears the gang
    # down and the job is replayed once on a fresh gang.  Workers send a
    # progress frame every gang_heartbeat_s while a job runs (0 disables
    # the watchdog)...
    gang_heartbeat_s: float = 2.0
    # ...a worker silent for longer than this is declared wedged...
    gang_heartbeat_timeout_s: float = 60.0
    # ...and once the first reply lands, the rest must land within
    # max(rel x the first reply's latency, abs seconds), unless their
    # heartbeats still flow
    gang_straggler_rel_margin: float = 1.0
    gang_straggler_abs_margin_s: float = 15.0
    # a driver-side stream on a cluster Context (Dataset.from_stream,
    # read_text_stream) is SPOOLED into a store under this directory,
    # which the workers must reach (a shared filesystem or hdfs://), and
    # the gang streams that store (FromEnumerable parity: the client
    # writes the enumerable into cluster storage, DryadLinqContext.cs:
    # 1210).  None = a driver temporary directory (single-machine
    # clusters)
    cluster_stream_spool_dir: Optional[str] = None

    # -- task farm / speculation (runtime/farm.py) -------------------------
    # EnableSpeculativeDuplication + DrStageStatistics caps
    speculation_enabled: bool = True
    speculation_duplication_budget: float = 0.2
    speculation_outlier_sigma: float = 3.0
    speculation_min_samples: int = 5
    speculation_rel_margin: float = 0.5
    speculation_abs_margin_s: float = 0.5
    farm_task_timeout_s: float = 600.0

    # -- planner (plan/planner.py) -----------------------------------------
    # default fan-out allowance for join output capacity (out = expansion *
    # left capacity); per-join override via Dataset.join(expansion=...)
    join_expansion: float = 1.0
    # broadcast the build side instead of hash-exchanging both sides when
    # its capacity is at most this fraction of the probe side's
    broadcast_join_threshold: float = 0.0   # 0 disables auto-broadcast

    # -- iteration (api do_while) ------------------------------------------
    max_loop_iterations: int = 1000

    # -- collect shrink policy (exec/data.py) ------------------------------
    collect_shrink_min_capacity: int = 1024
    collect_shrink_waste_factor: int = 4

    # -- text (api read_text / split_words / ops/text.py) ------------------
    text_max_line_len: int = 256
    token_delims: bytes = b" \t\r\n.,;:!?\"'()[]{}<>"
    token_max_len: int = 24
    string_max_len: int = 64          # from_columns string payload bytes

    # -- store (io/store.py) -----------------------------------------------
    # default compression of to_store (None | "gzip")
    store_compression: Optional[str] = None
    # verify the fnv64 partition checksums on read
    store_verify_checksums: bool = True

    # -- out-of-core streaming (exec/ooc.py, exec/stream_exec.py) ----------
    # default chunk size of the ChunkSource constructors
    ooc_chunk_rows: int = 1 << 16
    # scatter fan-out of the streamed group-bys, distinct and top-k
    ooc_hash_buckets: int = 64
    # chunks in flight on the device (the double-buffered stream's depth)
    ooc_inflight: int = 2
    # a streamed sort whose whole data (counted by its sampling pass)
    # fits this many bytes skips the bucket round trip: one copy to the
    # device, one sort, one copy back.  0 always takes the out-of-core
    # machinery
    ooc_incore_bytes: int = 1 << 30
    # from_store streams when the store holds at least this many rows
    # (0 = never); read_store_stream always streams
    ooc_auto_stream_rows: int = 0
    # the most rows the materialized build side of a streamed join holds
    ooc_join_build_rows: int = 1 << 18
    # chunks a background thread reads ahead of the device (store reads,
    # unpacking); 0 reads in the consumer's thread
    ooc_prefetch_depth: int = 2
    # cache() of streamed (or edge-scale in-memory) data writes a local
    # chunked store keyed by the query's stable fingerprint and re-streams
    # it on later passes; False spools streamed data to an unvalidated
    # temporary store and keeps in-memory data on the card
    ooc_restream_cache: bool = True
    # where the re-streaming cache's entries live; None = a temporary
    # directory of the Context, removed with it
    ooc_cache_dir: Optional[str] = None
    # the most raw rows one key bucket of a streamed group_apply /
    # group_median holds on the device (whole groups do not compact)
    ooc_group_bucket_rows: int = 1 << 21
    # pick read_store_stream's chunk rows from measured copy and dispatch
    # rates (exec/autotune.pick_chunk_rows); explicit chunk_rows wins
    ooc_chunk_autotune: bool = False

    def __post_init__(self):
        checks = [
            (self.max_capacity_retries >= 0, "max_capacity_retries >= 0"),
            (self.initial_send_slack >= 1, "initial_send_slack >= 1"),
            (self.exchange_probe_min_mb >= -1,
             "exchange_probe_min_mb >= -1"),
            (self.range_samples_per_partition >= 2,
             "range_samples_per_partition >= 2"),
            (self.salt_trigger_factor >= 2, "salt_trigger_factor >= 2"),
            (self.salt_hot_factor >= 1.0, "salt_hot_factor >= 1.0"),
            (self.salt_topk >= 1, "salt_topk >= 1"),
            (self.join_expansion > 0, "join_expansion > 0"),
            (self.failure_budget >= 0, "failure_budget >= 0"),
            (self.spill_compression in (None, "gzip"),
             "spill_compression in (None, 'gzip')"),
            (self.store_compression in (None, "gzip"),
             "store_compression in (None, 'gzip')"),
            (self.cluster_processes >= 1, "cluster_processes >= 1"),
            (self.cluster_devices_per_process >= 1,
             "cluster_devices_per_process >= 1"),
            (self.gang_heartbeat_s >= 0, "gang_heartbeat_s >= 0"),
            (self.gang_heartbeat_timeout_s > 0,
             "gang_heartbeat_timeout_s > 0"),
            (self.gang_straggler_rel_margin >= 0,
             "gang_straggler_rel_margin >= 0"),
            (self.gang_straggler_abs_margin_s > 0,
             "gang_straggler_abs_margin_s > 0"),
            (0.0 <= self.speculation_duplication_budget <= 1.0,
             "speculation_duplication_budget in [0, 1]"),
            (self.speculation_min_samples >= 1,
             "speculation_min_samples >= 1"),
            (self.broadcast_join_threshold >= 0,
             "broadcast_join_threshold >= 0"),
            (self.max_loop_iterations >= 1, "max_loop_iterations >= 1"),
            (self.text_max_line_len >= 1, "text_max_line_len >= 1"),
            (self.token_max_len >= 1, "token_max_len >= 1"),
            (self.string_max_len >= 1, "string_max_len >= 1"),
            (len(self.token_delims) >= 1, "token_delims non-empty"),
            (self.device_hbm_bytes >= 0, "device_hbm_bytes >= 0"),
            (self.lint in ("off", "warn", "error"),
             "lint in ('off', 'warn', 'error')"),
            (self.adaptive in ("off", "on"),
             "adaptive in ('off', 'on')"),
            (self.adapt_skew_factor >= 1.0, "adapt_skew_factor >= 1.0"),
            (self.adapt_agg_collapse_rows >= 1,
             "adapt_agg_collapse_rows >= 1"),
            (self.adapt_agg_expand_rows >= 1,
             "adapt_agg_expand_rows >= 1"),
            (self.adapt_shrink_factor >= 1.0,
             "adapt_shrink_factor >= 1.0"),
            (self.adapt_broadcast_max_ratio > 0,
             "adapt_broadcast_max_ratio > 0"),
            (self.ooc_chunk_rows >= 1, "ooc_chunk_rows >= 1"),
            (self.ooc_hash_buckets >= 1, "ooc_hash_buckets >= 1"),
            (self.ooc_inflight >= 1, "ooc_inflight >= 1"),
            (self.ooc_incore_bytes >= 0, "ooc_incore_bytes >= 0"),
            (self.ooc_auto_stream_rows >= 0, "ooc_auto_stream_rows >= 0"),
            (self.ooc_join_build_rows >= 1, "ooc_join_build_rows >= 1"),
            (self.ooc_prefetch_depth >= 0, "ooc_prefetch_depth >= 0"),
            (self.ooc_group_bucket_rows > 0, "ooc_group_bucket_rows > 0"),
            (self.resource_sample_s >= 0, "resource_sample_s >= 0"),
        ]
        bad = [msg for ok, msg in checks if not ok]
        if bad:
            raise ValueError("invalid JobConfig: " + "; ".join(bad))

    def replace(self, **kw) -> "JobConfig":
        """A copy with ``kw``'s fields changed (validated again)."""
        return dataclasses.replace(self, **kw)
