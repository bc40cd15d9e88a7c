"""TeraSort through the port's Dataset API: every record ordered by its
10-byte key, materialised range-partitioned on the card by ``cache()``,
where a downstream stage would read it.  Each job keeps its partition
counts; only the last job's output is held, for the check."""

from __future__ import annotations

from portbench import resident

TERMINAL = "cache"


def setup(port, config: dict, tables: dict, device):
    ctx = resident.context(port, config, device)
    return ctx, resident.sources(ctx, tables)


def query(src: dict, params: dict):
    return src["records"].order_by([("key", False)])


def run(ctx, src: dict, params: dict):
    """One job to its terminal: (what every job keeps, the output)."""
    out = resident.as_table(query(src, params).cache().node.data)
    return out["counts"], out
