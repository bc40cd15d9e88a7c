"""TPC-H Q1 (the pricing summary report) through the port's Dataset API.

    SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty,
           SUM(l_extendedprice) AS sum_base_price,
           SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
           SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax))
               AS sum_charge,
           AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price,
           AVG(l_discount) AS avg_disc, COUNT(*) AS count_order
    FROM lineitem
    WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL :delta DAY
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus

Decimals stay exact int64: quantities, prices, discounts and taxes in
hundredths, ``sum_disc_price`` in units of 1e-4 and ``sum_charge`` in
units of 1e-6.  Each average is returned as its exact sum beside
``count_order`` (``sum_disc`` is the discounts' sum); the quotient is the
reader's to take.
"""

from __future__ import annotations

from portbench import resident
from portbench.generators.tpch import day

TERMINAL = "collect"
# the report's last day before DELTA is taken off
END = day("1998-12-01")


def setup(port, config: dict, tables: dict, device):
    ctx = resident.context(port, config, device)
    return ctx, resident.sources(ctx, tables)


def query(src: dict, params: dict):
    """The query over the resident tables ``src`` (table -> Dataset)."""
    last = END - int(params["delta"])

    def terms(c):
        disc_price = c["l_extendedprice"] * (100 - c["l_discount"])
        return {"l_returnflag": c["l_returnflag"],
                "l_linestatus": c["l_linestatus"],
                "qty": c["l_quantity"], "price": c["l_extendedprice"],
                "disc": c["l_discount"], "disc_price": disc_price,
                "charge": disc_price * (100 + c["l_tax"])}

    return (src["lineitem"].where(lambda c: c["l_shipdate"] <= last)
            .select(terms)
            .group_by(["l_returnflag", "l_linestatus"],
                      {"sum_qty": ("sum", "qty"),
                       "sum_base_price": ("sum", "price"),
                       "sum_disc_price": ("sum", "disc_price"),
                       "sum_charge": ("sum", "charge"),
                       "sum_disc": ("sum", "disc"),
                       "count_order": ("count", None)})
            .order_by([("l_returnflag", False), ("l_linestatus", False)]))


def run(ctx, src: dict, params: dict):
    """One job to its terminal: (what every job keeps, the output).  The
    report is four rows, so every job keeps it."""
    return query(src, params).collect(), None
