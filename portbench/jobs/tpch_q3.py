"""TPC-H Q3 (the shipping priority query) through the port's Dataset API.

    SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = :segment AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey
      AND o_orderdate < :date AND l_shipdate > :date
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate
    LIMIT 10

``revenue`` is exact: ``l_extendedprice`` in cents times ``100 -
l_discount`` in hundredths, an int64 in units of 1e-4 (a dollar is
10,000).  The primary-key sides of the joins are declared unique, as the
schema makes them.
"""

from __future__ import annotations

import torch

from portbench import resident
from portbench.generators.tpch import day

TERMINAL = "collect"


def setup(port, config: dict, tables: dict, device):
    ctx = resident.context(port, config, device)
    return ctx, resident.sources(ctx, tables)


def string_equals(col, word: bytes) -> torch.Tensor:
    """Rows of a string column equal to ``word``."""
    want = torch.tensor(list(word), dtype=torch.uint8,
                        device=col.data.device)
    return ((col.lengths == len(word))
            & (col.data[:, :len(word)] == want).all(1))


def query(src: dict, params: dict):
    """The query over the resident tables ``src`` (table -> Dataset)."""
    seg = params["segment"].encode()
    d = day(params["date"])
    cust = (src["customer"]
            .where(lambda c: string_equals(c["c_mktsegment"], seg))
            .select(lambda c: {"c_custkey": c["c_custkey"]}))
    orders = (src["orders"].where(lambda c: c["o_orderdate"] < d)
              .join(cust, ["o_custkey"], ["c_custkey"], right_unique=True)
              .select(lambda c: {"o_orderkey": c["o_orderkey"],
                                 "o_orderdate": c["o_orderdate"],
                                 "o_shippriority": c["o_shippriority"]}))
    lines = (src["lineitem"].where(lambda c: c["l_shipdate"] > d)
             .select(lambda c: {
                 "l_orderkey": c["l_orderkey"],
                 "rev": c["l_extendedprice"] * (100 - c["l_discount"])}))
    return (lines.join(orders, ["l_orderkey"], ["o_orderkey"],
                       right_unique=True)
            .group_by(["l_orderkey", "o_orderdate", "o_shippriority"],
                      {"revenue": ("sum", "rev")})
            .order_by([("revenue", True), ("o_orderdate", False)])
            .take(10))


def run(ctx, src: dict, params: dict):
    """One job to its terminal: (what every job keeps, the output).  The
    answer is small, so every job keeps it."""
    return query(src, params).collect(), None
