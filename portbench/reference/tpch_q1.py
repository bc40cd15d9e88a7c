"""The plain reference of TPC-H Q1 (``jobs/tpch_q1.py``), in plain PyTorch,
and the comparison that decides ``correct``.

It reads the generated tables (``tables.py``'s layout) and nothing of the
program.  Each qualifying lineitem's group is its return flag's code
times two plus its line status's; every sum is added to its group with
``index_add_``.  With ``precision "exact"`` the sums are int64 in the
program's units (hundredths; ``sum_disc_price`` 1e-4, ``sum_charge``
1e-6), which no rounding touches.  ``"f32"`` is the control: the same
query with the decimals held as float32 dollars and summed in float32,
as a port that trades the exact columns for 32-bit floats would compute
it, each sum then rounded to the program's unit.

Every job of the window is judged: its four rows, in (flag, status)
order, against the reference's.  ``q1_groups_gap`` counts rows missing,
extra or out of place; ``q1_cells_wrong`` counts the report's cells (8 a
group: four sums, three averages, the count) that differ from the
reference's.  An average is compared as its (sum, count) pair, so it is
right when both are.
"""

from __future__ import annotations

import torch

from portbench import tables as T
from portbench.generators.tpch import day

FLAGS, STATUSES = (b"N", b"R", b"A"), (b"O", b"F")
SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
        "sum_disc")
# the averages, each as the sum it divides by count_order
AVERAGES = {"avg_qty": "sum_qty", "avg_price": "sum_base_price",
            "avg_disc": "sum_disc"}
CELLS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
         "avg_qty", "avg_price", "avg_disc", "count_order")
# every number compared, with its limit: the answer is exact
LIMITS = {"q1_cells_wrong": 0, "q1_groups_gap": 0}


def _col(table, name):
    return T.valid_rows(table["columns"][name], table["counts"])


def _codes(table, name, words) -> torch.Tensor:
    """Each row's index into ``words`` of a one-byte string column."""
    data = T.valid_rows(table["columns"][name][0], table["counts"])
    data = data[:, 0].long()
    code = torch.full(data.shape, -1, dtype=torch.int64, device=data.device)
    for i, w in enumerate(words):
        code[data == w[0]] = i
    return code


def reference(tables: dict, params: dict, precision: str = "exact") -> dict:
    """The report: ``(flag, status)`` -> its cells, in (flag, status)
    order, over the groups that have rows."""
    li = tables["lineitem"]
    last = day("1998-12-01") - int(params["delta"])
    keep = _col(li, "l_shipdate") <= last
    group = (_codes(li, "l_returnflag", FLAGS) * 2
             + _codes(li, "l_linestatus", STATUSES))[keep]
    qty, price, disc, tax = (_col(li, c)[keep] for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    if precision == "exact":
        terms = {"sum_qty": qty, "sum_base_price": price, "sum_disc": disc,
                 "sum_disc_price": price * (100 - disc),
                 "sum_charge": price * (100 - disc) * (100 + tax)}
    elif precision == "f32":
        q, p, d, t = (x.to(torch.float32) / 100 for x in (qty, price, disc,
                                                          tax))
        terms = {"sum_qty": q, "sum_base_price": p, "sum_disc": d,
                 "sum_disc_price": p * (1 - d),
                 "sum_charge": p * (1 - d) * (1 + t)}
    else:
        raise ValueError(f"unknown precision {precision!r}")
    # the program's unit of each sum, in dollars (quantities and
    # discounts in hundredths)
    unit = {"sum_qty": 100, "sum_base_price": 100, "sum_disc": 100,
            "sum_disc_price": 10_000, "sum_charge": 1_000_000}
    n = len(FLAGS) * len(STATUSES)
    count = torch.bincount(group, minlength=n)
    sums = {}
    for name, v in terms.items():
        s = torch.zeros(n, dtype=v.dtype, device=v.device)
        s.index_add_(0, group, v)
        sums[name] = (s if precision == "exact"
                      else (s.double() * unit[name]).round().long())
    order = sorted((FLAGS[g // 2], STATUSES[g % 2], g) for g in range(n)
                   if int(count[g]))
    return {(f, s): dict({k: int(sums[k][g]) for k in SUMS},
                         count_order=int(count[g]))
            for f, s, g in order}


def cells(row: dict) -> dict:
    """A row's eight report cells, each average as its (sum, count)."""
    out = {k: row[k] for k in CELLS if k in row}
    for avg, total in AVERAGES.items():
        out[avg] = (row[total], row["count_order"])
    return out


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one answer (column -> values)."""
    keys = [(bytes(f), bytes(s)) for f, s in zip(got["l_returnflag"],
                                                 got["l_linestatus"])]
    rows = {k: {c: int(got[c][i]) for c in SUMS + ("count_order",)}
            for i, k in enumerate(keys)}
    order = list(want)
    gap = abs(len(keys) - len(order)) + sum(
        a != b for a, b in zip(keys, order))
    wrong = 0
    for k in order:
        true = cells(want[k])
        have = cells(rows[k]) if k in rows else {}
        wrong += sum(have.get(c) != v for c, v in true.items())
    return {"q1_cells_wrong": wrong, "q1_groups_gap": gap}


def check(tables: dict, params: dict, jobs: list, last) -> tuple:
    """Every job of the window against the reference: the worst of each
    number over the jobs, and the number of jobs that failed."""
    want = reference(tables, params)
    worst, failed = {k: 0 for k in LIMITS}, 0
    for j in jobs:
        nums = compare(j["keep"], want)
        failed += any(nums[k] > LIMITS[k] for k in nums)
        worst = {k: max(worst[k], nums[k]) for k in nums}
    return worst, failed


def control_answer(tables: dict, params: dict) -> dict:
    """The control's answer, in the program's place and layout: the
    reference computed over float32 decimals."""
    rows = reference(tables, params, precision="f32")
    out = {"l_returnflag": [f for f, _s in rows],
           "l_linestatus": [s for _f, s in rows]}
    for c in SUMS + ("count_order",):
        out[c] = [r[c] for r in rows.values()]
    return out


def control(tables: dict, params: dict) -> dict:
    """The control's numbers: its answer against the exact reference."""
    return compare(control_answer(tables, params),
                   reference(tables, params))
