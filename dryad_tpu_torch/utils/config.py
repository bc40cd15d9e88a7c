"""Job configuration — the subset of ``dryad_tpu/utils/config.JobConfig``
that the port's ported paths read.  Field names and defaults match the
JAX package, so one set of overrides means the same thing to both."""

from __future__ import annotations

import dataclasses

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

    # -- text (api split_words / ops/text.py) ------------------------------
    token_delims: bytes = b" \t\r\n.,;:!?\"'()[]{}<>"
    token_max_len: int = 24
    string_max_len: int = 64          # from_columns string payload bytes

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
            (self.broadcast_join_threshold >= 0,
             "broadcast_join_threshold >= 0"),
            (self.max_loop_iterations >= 1, "max_loop_iterations >= 1"),
            (self.token_max_len >= 1, "token_max_len >= 1"),
            (self.string_max_len >= 1, "string_max_len >= 1"),
            (len(self.token_delims) >= 1, "token_delims non-empty"),
        ]
        bad = [msg for ok, msg in checks if not ok]
        if bad:
            raise ValueError("invalid JobConfig: " + "; ".join(bad))
