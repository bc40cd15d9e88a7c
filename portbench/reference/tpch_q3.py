"""The plain reference of TPC-H Q3 (``jobs/tpch_q3.py``), in plain
PyTorch, and the comparison that decides ``correct``.

It reads the generated tables (``tables.py``'s layout) and nothing of the
program.  Customers and orders are looked up through dense tables indexed
by key; each qualifying lineitem's revenue is added to its order with
``index_add_``; the top 10 come from two stable sorts.  With ``precision
"exact"`` revenue is int64 in units of 1e-4 (cents x hundredths), which
no rounding touches.  ``"f32"`` is the control: the same query with the
decimals held as float32 dollars, as a port that trades the exact
columns for 32-bit floats would compute it.

Every job of the window is judged.  Its answer, the top 10, depends on
some 70 lineitems; so the check also reads the job's own stage log, where
the program counted the rows each exchange received.  The inputs of the
two joins have to be the reference's filtered relations (orders before
the date and customers of the segment; lineitems shipped after the date
and the orders those two joined to), and the order-by has to receive one
row per qualifying order.  A lost or repeated row anywhere in the filters,
the first join or the group-by shows there, beyond the top 10.  These two
counts read the present plan's stages: a program that changes the plan
(a broadcast join, a top 10 taken before the range exchange, a semi-join
filter on the lineitems) changes what those stages receive, and needs the
counts read anew.
"""

from __future__ import annotations

import torch

from portbench import tables as T
from portbench.generators.tpch import SEGMENTS, day

TOP = 10
# every number compared, with its limit: the answer is exact
LIMITS = {"q3_rows_wrong": 0, "q3_revenue_gap": 0, "q3_join_rows_gap": 0,
          "q3_groups_gap": 0}


def _col(table, name):
    return T.valid_rows(table["columns"][name], table["counts"])


def _segment_codes(table) -> torch.Tensor:
    data, lens = table["columns"]["c_mktsegment"]
    data, lens = (T.valid_rows(data, table["counts"]),
                  T.valid_rows(lens, table["counts"]))
    code = torch.full(lens.shape, -1, dtype=torch.int64, device=lens.device)
    for i, w in enumerate(SEGMENTS):
        want = torch.zeros(data.shape[1], dtype=torch.uint8)
        want[:len(w)] = torch.tensor(list(w), dtype=torch.uint8)
        hit = (lens == len(w)) & (data == want.to(data.device)).all(1)
        code[hit] = i
    return code


def revenue_by_order(tables: dict, params: dict, precision: str = "exact"):
    """(order keys, order dates, ship priorities, revenues) of every
    order with a qualifying lineitem, and the sizes of the relations the
    joins take in.  Revenue is in units of 1e-4 dollar: exact int64, or
    float64 holding the float32 sum for ``"f32"``."""
    cust, orders, li = (tables["customer"], tables["orders"],
                        tables["lineitem"])
    seg = SEGMENTS.index(params["segment"].encode())
    d = day(params["date"])
    ckey = _col(cust, "c_custkey").long()
    in_seg = torch.zeros(int(ckey.max()) + 1, dtype=torch.bool,
                         device=ckey.device)
    cust_seg = _segment_codes(cust) == seg
    in_seg[ckey] = cust_seg
    okey = _col(orders, "o_orderkey").long()
    odate = _col(orders, "o_orderdate")
    keep = (odate < d) & in_seg[_col(orders, "o_custkey").long()]
    slot = torch.full((int(okey.max()) + 1,), -1, dtype=torch.int64,
                      device=okey.device)
    slot[okey[keep]] = torch.arange(int(keep.sum()), device=okey.device)
    lkey = _col(li, "l_orderkey").long()
    at = slot[lkey]
    shipped = _col(li, "l_shipdate") > d
    hit = shipped & (at >= 0)
    at = at[hit]
    price = _col(li, "l_extendedprice")[hit]
    disc = _col(li, "l_discount")[hit]
    n = int(keep.sum())
    if precision == "exact":
        rev = torch.zeros(n, dtype=torch.int64, device=at.device)
        rev.index_add_(0, at, price * (100 - disc))
        lines = torch.zeros(n, dtype=torch.int64, device=at.device)
        lines.index_add_(0, at, torch.ones_like(at))
    elif precision == "f32":
        dollars = (price.to(torch.float32) / 100) * (
            1 - disc.to(torch.float32) / 100)
        rev = torch.zeros(n, dtype=torch.float32, device=at.device)
        rev.index_add_(0, at, dollars)
        lines = torch.zeros(n, dtype=torch.int64, device=at.device)
        lines.index_add_(0, at, torch.ones_like(at))
        rev = rev.double() * 10_000
    else:
        raise ValueError(f"unknown precision {precision!r}")
    has = lines > 0
    sizes = {"joins": [sorted([int((odate < d).sum()), int(cust_seg.sum())]),
                       sorted([int(shipped.sum()), n])],
             "groups": int(has.sum())}
    return (okey[keep][has], odate[keep][has],
            _col(orders, "o_shippriority")[keep][has], rev[has]), sizes


def top_rows(okey, odate, prio, rev) -> dict:
    """The first ``TOP`` rows by revenue descending, then order date."""
    o1 = torch.sort(odate.long(), stable=True).indices
    o2 = torch.sort(rev[o1], descending=True, stable=True).indices
    pick = o1[o2][:TOP]
    return {"l_orderkey": okey[pick].tolist(),
            "o_orderdate": odate[pick].tolist(),
            "o_shippriority": prio[pick].tolist(),
            "revenue": rev[pick].tolist()}


def reference(tables: dict, params: dict, precision: str = "exact") -> dict:
    """What the answer has to be: the top rows, and each qualifying
    order's (date, priority, revenue) by key, which judges rows that tie
    at the tenth place."""
    (okey, odate, prio, rev), sizes = revenue_by_order(tables, params,
                                                       precision)
    top = top_rows(okey, odate, prio, rev)
    by_key = dict(zip(okey.tolist(), zip(odate.tolist(), prio.tolist(),
                                         rev.tolist())))
    return {"top": top, "by_key": by_key, "sizes": sizes}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one answer: rows that are not a true
    result row at their rank (a wrong key, date, priority or revenue, a
    repeated key, a missing or extra row), and the largest gap between a
    row's revenue and the reference's at the same rank, in 1e-4 dollars.
    Rows that tie on (revenue, date) may come in either order."""
    top, by_key = want["top"], want["by_key"]
    n = len(top["revenue"])
    rows = list(zip(*(list(got[k]) for k in
                      ("l_orderkey", "o_orderdate", "o_shippriority",
                       "revenue"))))
    wrong = abs(len(rows) - n)
    gap = 0.0
    seen = set()
    for i, (k, d, p, r) in enumerate(rows[:n]):
        true = by_key.get(int(k))
        ok = (true is not None and int(k) not in seen
              and (int(d), int(p)) == true[:2] and int(r) == true[2]
              and int(r) == top["revenue"][i]
              and int(d) == top["o_orderdate"][i])
        wrong += not ok
        seen.add(int(k))
        gap = max(gap, abs(float(r) - float(top["revenue"][i])))
    for i in range(len(rows), n):
        gap = max(gap, abs(float(top["revenue"][i])))
    return {"q3_rows_wrong": wrong, "q3_revenue_gap": gap}


def received(stages: list, label: str) -> list:
    """Per stage labelled ``label`` in a job's stage log, the rows each
    of its exchanging legs received, in ascending order."""
    return [sorted(sum(r) for r in s["recv_rows"]) for s in stages
            if s["label"] == label]


def compare_counts(stages: list, want: dict) -> dict:
    """The numbers compared on one job's stage log: the rows by which the
    joins' received inputs miss the reference's relation sizes, and by
    which the order-by's received rows miss its number of orders.  A log
    of another shape misses by every row."""
    sizes = want["sizes"]
    got, exp = sorted(received(stages, "join")), sorted(sizes["joins"])
    if [len(g) for g in got] == [len(e) for e in exp]:
        join_gap = sum(abs(a - b) for g, e in zip(got, exp)
                       for a, b in zip(g, e))
    else:
        join_gap = sum(map(sum, exp)) + sum(map(sum, got))
    order = received(stages, "orderby")
    groups_gap = (abs(sum(order[0]) - sizes["groups"]) if len(order) == 1
                  else sizes["groups"] + sum(map(sum, order)))
    return {"q3_join_rows_gap": join_gap, "q3_groups_gap": groups_gap}


def check(tables: dict, params: dict, jobs: list, last) -> tuple:
    """Every job of the window against the reference: the worst of each
    number over the jobs, and the number of jobs that failed.  A job
    keeps its collected answer and its stage log."""
    want = reference(tables, params)
    worst, failed = {k: 0 for k in LIMITS}, 0
    for j in jobs:
        nums = compare(j["keep"], want)
        nums.update(compare_counts(j["stages"], want))
        failed += any(nums[k] > LIMITS[k] for k in nums)
        worst = {k: max(worst[k], nums[k]) for k in nums}
    return worst, failed


def control_answer(tables: dict, params: dict) -> dict:
    """The control's answer, in the program's place: the reference
    computed over float32 decimals, its revenue rounded to 1e-4 dollar."""
    top = reference(tables, params, precision="f32")["top"]
    top["revenue"] = [int(round(r)) for r in top["revenue"]]
    return top


def control(tables: dict, params: dict) -> dict:
    """The control's numbers: its answer against the exact reference.
    Decimals held as float32 change no relation's size, so the control
    gives no stage counts to compare."""
    return compare(control_answer(tables, params),
                   reference(tables, params))
