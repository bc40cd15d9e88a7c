"""TPC-H tables on the device, generated by the rules of the TPC-H
specification, clause 4.2 (what dbgen does), from a seed.

Only the columns a cell's traffic reads are made (``reads``: table ->
column names).  Keys, dates and prices follow clause 4.2.3:

* ``c_custkey`` 1 .. SF * 150,000; ``c_mktsegment`` uniform over the five
  segments.
* ``o_orderkey`` sparse: order ``i`` (from 0) has key
  ``32 * (i // 8) + i % 8 + 1``, the first 8 of every 32 keys.
  ``o_custkey`` uniform over the customer keys that 3 does not divide.
  ``o_orderdate`` uniform in [1992-01-01, 1998-08-02].
  ``o_shippriority`` 0.
* Each order has 1 to 7 lineitems.  Every seed gets the same multiset of
  line counts (1 + i % 7 over the orders), dealt to the orders in an
  order drawn from the seed, so the lineitem count is the same for
  every seed and each order's count is uniform on 1 .. 7.
* ``l_partkey`` uniform in 1 .. SF * 200,000; ``l_quantity`` 1 .. 50;
  ``l_extendedprice`` = quantity x ``P_RETAILPRICE(l_partkey)``;
  ``l_discount`` 0.00 .. 0.10; ``l_tax`` 0.00 .. 0.08;
  ``l_shipdate`` = order date + 1 .. 121 days; ``l_commitdate`` = order
  date + 30 .. 90; ``l_receiptdate`` = ship date + 1 .. 30;
  ``l_returnflag`` "R" or "A" where the receipt date is on or before
  CURRENTDATE (1995-06-17), else "N"; ``l_linestatus`` "O" where the ship
  date is after CURRENTDATE, else "F".

Dates are int32 days since 1970-01-01.  A decimal(15,2) column is int64
hundredths (cents for prices), so sums over it are exact.  Strings are
the port's string columns.
"""

from __future__ import annotations

import datetime

import torch

from portbench import tables as T


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


START, LAST_ORDER, CURRENT = (day("1992-01-01"), day("1998-08-02"),
                              day("1995-06-17"))
SEGMENTS = (b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"HOUSEHOLD",
            b"MACHINERY")
SEGMENT_LEN = 10
LINES_MAX = 7


def sizes(sf: float) -> dict:
    n_cust = int(150_000 * sf)
    n_ord = int(1_500_000 * sf)
    full, rest = divmod(n_ord, LINES_MAX)
    n_line = (full * LINES_MAX * (LINES_MAX + 1) // 2
              + rest * (rest + 1) // 2)
    return {"customer": n_cust, "orders": n_ord, "lineitem": n_line,
            "part": int(200_000 * sf)}


def order_keys(i: torch.Tensor) -> torch.Tensor:
    """dbgen's sparse key of order index ``i`` (from 0)."""
    return 32 * (i // 8) + i % 8 + 1


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE x 100 (clause 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


class _Gen:
    """Columns made on demand, each once."""

    def __init__(self, cfg: dict, seed: int, device):
        self.n = sizes(cfg["scale_factor"])
        self.seed, self.dev = seed, device
        self.memo: dict = {}

    def get(self, name: str) -> torch.Tensor:
        if name not in self.memo:
            self.memo[name] = getattr(self, name)()
        return self.memo[name]

    def _rand(self, name, lo, hi, n):
        return T.randint(self.seed, name, lo, hi, n, self.dev)

    # -- customer
    def c_custkey(self):
        return torch.arange(1, self.n["customer"] + 1, device=self.dev,
                            dtype=torch.int32)

    def c_mktsegment_code(self):
        return self._rand("c_mktsegment", 0, len(SEGMENTS) - 1,
                          self.n["customer"])

    # -- orders
    def o_index(self):
        return torch.arange(self.n["orders"], device=self.dev,
                            dtype=torch.int64)

    def o_orderkey(self):
        return order_keys(self.get("o_index")).to(torch.int32)

    def o_custkey(self):
        n_cust = self.n["customer"]
        r = self._rand("o_custkey", 0, n_cust - n_cust // 3 - 1,
                       self.n["orders"])
        # the r-th key (from 0) of 1, 2, 4, 5, 7, ...: no multiple of 3
        return (r + r // 2 + 1).to(torch.int32)

    def o_orderdate(self):
        return self._rand("o_orderdate", START, LAST_ORDER,
                          self.n["orders"]).to(torch.int32)

    def o_shippriority(self):
        return torch.zeros(self.n["orders"], device=self.dev,
                           dtype=torch.int32)

    # -- lineitem
    def lines_per_order(self):
        n = self.n["orders"]
        g = T.column_generator(self.seed, "lines_per_order", self.dev)
        deal = torch.randperm(n, generator=g, device=self.dev)
        return (1 + deal % LINES_MAX).to(torch.int64)

    def l_order_index(self):
        return torch.repeat_interleave(self.get("o_index"),
                                       self.get("lines_per_order"))

    def l_orderkey(self):
        return order_keys(self.get("l_order_index")).to(torch.int32)

    def _l_orderdate(self):
        return self.get("o_orderdate").index_select(
            0, self.get("l_order_index"))

    def l_partkey(self):
        return self._rand("l_partkey", 1, self.n["part"],
                          self.n["lineitem"]).to(torch.int32)

    def l_quantity(self):
        return self._rand("l_quantity", 1, 50, self.n["lineitem"]) * 100

    def l_extendedprice(self):
        qty = self.get("l_quantity") // 100
        return qty * retail_price_cents(self.get("l_partkey").long())

    def l_discount(self):
        return self._rand("l_discount", 0, 10, self.n["lineitem"])

    def l_tax(self):
        return self._rand("l_tax", 0, 8, self.n["lineitem"])

    def l_shipdate(self):
        return (self._l_orderdate() + self._rand(
            "l_shipdate", 1, 121, self.n["lineitem"])).to(torch.int32)

    def l_commitdate(self):
        return (self._l_orderdate() + self._rand(
            "l_commitdate", 30, 90, self.n["lineitem"])).to(torch.int32)

    def l_receiptdate(self):
        return (self.get("l_shipdate") + self._rand(
            "l_receiptdate", 1, 30, self.n["lineitem"])).to(torch.int32)

    def l_returnflag_code(self):
        # 0 "N", 1 "R", 2 "A"
        ra = self._rand("l_returnflag", 1, 2, self.n["lineitem"])
        return torch.where(self.get("l_receiptdate") <= CURRENT, ra, 0)

    def l_linestatus_code(self):
        # 0 "O", 1 "F"
        return (self.get("l_shipdate") <= CURRENT).to(torch.int64)


STRINGS = {"c_mktsegment": ("c_mktsegment_code", SEGMENTS, SEGMENT_LEN),
           "l_returnflag": ("l_returnflag_code", (b"N", b"R", b"A"), 1),
           "l_linestatus": ("l_linestatus_code", (b"O", b"F"), 1)}


def make(cfg: dict, reads: dict, seed: int, device) -> dict:
    """The tables ``reads`` names, each with only the columns it lists,
    in ``tables``' layout over ``cfg["nparts"]`` partitions."""
    gen, P = _Gen(cfg, seed, device), cfg["nparts"]
    out = {}
    for table, cols in reads.items():
        made = {}
        for c in cols:
            if c in STRINGS:
                code, words, max_len = STRINGS[c]
                made[c] = T.string_codes(gen.get(code), words, max_len, P)
            else:
                made[c] = T.partitioned(gen.get(c), P)
        out[table] = T.make_table(made, gen.n[table], P, device)
    return out
