"""The generators follow their sources' rules, and the references give
hand-computed answers on hand-made tables."""

import pytest
import torch

from portbench import bench, tables as T
from portbench.generators import tpch as G
from portbench.generators import gensort as S

ALL = {"customer": ["c_custkey", "c_mktsegment"],
       "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                  "o_shippriority"],
       "lineitem": ["l_orderkey", "l_partkey", "l_quantity",
                    "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                    "l_commitdate", "l_receiptdate", "l_returnflag",
                    "l_linestatus"]}


def flat(t, c):
    return T.valid_rows(t["columns"][c], t["counts"])


def strings(t, c):
    data, lens = (T.valid_rows(x, t["counts"]) for x in t["columns"][c])
    return [bytes(r[:n].tolist()) for r, n in zip(data, lens.tolist())]


@pytest.fixture(scope="module")
def tpch():
    return G.make({"scale_factor": 0.02, "nparts": 8}, ALL, 2**40 + 3,
                  torch.device("cpu"))


def test_tpch_counts(tpch):
    assert tpch["customer"]["rows"] == 3000
    assert tpch["orders"]["rows"] == 30000
    n_li = tpch["lineitem"]["rows"]
    assert n_li == G.sizes(0.02)["lineitem"]
    assert abs(n_li - 4 * 30000) <= 28
    for t in tpch.values():
        assert int(t["counts"].sum()) == t["rows"]
    assert G.sizes(30)["lineitem"] == 179_999_994


def test_tpch_keys(tpch):
    ck = flat(tpch["customer"], "c_custkey")
    assert ck.tolist() == list(range(1, 3001))
    ok = flat(tpch["orders"], "o_orderkey").long()
    assert ((ok - 1) % 32 < 8).all() and ok.unique().numel() == 30000
    oc = flat(tpch["orders"], "o_custkey")
    assert (oc % 3 != 0).all() and oc.min() >= 1 and oc.max() <= 3000
    assert (flat(tpch["orders"], "o_shippriority") == 0).all()
    lk = flat(tpch["lineitem"], "l_orderkey")
    per = torch.bincount(lk.long())[ok]
    assert per.min() == 1 and per.max() == 7
    # each count 1..7 is dealt about equally
    assert torch.bincount(per, minlength=8)[1:].min() >= 30000 // 7


def test_tpch_dates_prices_and_flags(tpch):
    li, od = tpch["lineitem"], flat(tpch["orders"], "o_orderdate")
    assert od.min() >= G.START and od.max() <= G.LAST_ORDER
    okey = flat(tpch["orders"], "o_orderkey")
    lk = flat(li, "l_orderkey")
    odate = dict(zip(okey.tolist(), od.tolist()))
    o = torch.tensor([odate[k] for k in lk.tolist()])
    ship, commit, receipt = (flat(li, c) for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    assert ((ship - o) >= 1).all() and ((ship - o) <= 121).all()
    assert ((commit - o) >= 30).all() and ((commit - o) <= 90).all()
    assert ((receipt - ship) >= 1).all() and ((receipt - ship) <= 30).all()
    qty, price = flat(li, "l_quantity"), flat(li, "l_extendedprice")
    pk = flat(li, "l_partkey").long()
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    assert (qty % 100 == 0).all() and qty.min() >= 100 and qty.max() <= 5000
    assert (price == qty // 100 * retail).all()
    assert flat(li, "l_discount").max() <= 10
    assert flat(li, "l_tax").max() <= 8
    flag, status = strings(li, "l_returnflag"), strings(li, "l_linestatus")
    for f, s, sh, rc in zip(flag, status, ship.tolist(), receipt.tolist()):
        assert (f in (b"R", b"A")) == (rc <= G.CURRENT)
        assert f in (b"R", b"A", b"N")
        assert s == (b"O" if sh > G.CURRENT else b"F")
    seg = set(strings(tpch["customer"], "c_mktsegment"))
    assert seg == set(G.SEGMENTS)


def test_tpch_seed_decides_values_not_sizes():
    cfg = {"scale_factor": 0.01, "nparts": 8}
    reads = {"lineitem": ["l_orderkey", "l_shipdate"]}
    a = G.make(cfg, reads, 1, torch.device("cpu"))
    b = G.make(cfg, reads, 1, torch.device("cpu"))
    c = G.make(cfg, reads, 2**31 + 9, torch.device("cpu"))
    assert torch.equal(flat(a["lineitem"], "l_shipdate"),
                       flat(b["lineitem"], "l_shipdate"))
    assert a["lineitem"]["rows"] == c["lineitem"]["rows"]
    assert not torch.equal(flat(a["lineitem"], "l_orderkey"),
                           flat(c["lineitem"], "l_orderkey"))


def test_gensort_records():
    t = S.make({"records": 1000, "nparts": 8},
               {"records": ["key", "payload"]}, 7, torch.device("cpu"))
    rec = t["records"]
    keys, pays = strings(rec, "key"), strings(rec, "payload")
    assert len(keys) == 1000 and all(len(k) == 10 for k in keys)
    assert all(0x20 <= b <= 0x7E for k in keys for b in k)
    for i in (0, 1, 999):
        p = pays[i]
        assert len(p) == 90 and p[:2] == b"  " and p[34:36] == b"  "
        assert int(p[2:34], 16) == i and p[-2:] == b"\r\n"
        fill = p[36:88]
        assert all(fill[j:j + 4] == fill[j:j + 1] * 4
                   for j in range(0, 52, 4))


def hand_tables():
    """Three customers, four orders, seven lineitems (P = 2)."""
    P, dev = 2, torch.device("cpu")
    d = G.day

    def table(cols, n):
        out = {}
        for k, v in cols.items():
            if isinstance(v, tuple):
                out[k] = T.string_codes(torch.tensor(v[0]), v[1], 10, P)
            else:
                out[k] = T.partitioned(torch.tensor(v), P)
        return T.make_table(out, n, P, dev)

    seg = (b"BUILDING", b"MACHINERY")
    cust = table({"c_custkey": [1, 2, 4],
                  "c_mktsegment": ([0, 1, 0], seg)}, 3)
    orders = table({"o_orderkey": [1, 2, 3, 33],
                    "o_custkey": [1, 2, 4, 1],
                    "o_orderdate": [d("1995-03-01"), d("1995-03-01"),
                                    d("1995-03-10"), d("1995-03-20")],
                    "o_shippriority": [0, 0, 0, 0]}, 4)
    li = table({"l_orderkey": [1, 1, 2, 3, 3, 33, 1],
                "l_extendedprice": [1000, 2000, 9999, 500, 700, 8000, 300],
                "l_discount": [10, 0, 0, 5, 0, 0, 0],
                "l_shipdate": [d("1995-03-16"), d("1995-03-20"),
                               d("1995-03-20"), d("1995-03-16"),
                               d("1995-03-15"), d("1995-04-01"),
                               d("1995-03-01")]}, 7)
    return {"customer": cust, "orders": orders, "lineitem": li}


def test_q3_reference_by_hand():
    ref = bench.load_file(bench.os.path.join(bench.HERE, "reference",
                                             "tpch_q3.py"), "ref_q3_hand")
    want = ref.reference(hand_tables(), {"segment": "BUILDING",
                                         "date": "1995-03-15"})
    # order 1 (customer 1, BUILDING): lines 1 and 2 ship after the date:
    # 1000 * 90 + 2000 * 100 = 290,000; order 3 (customer 4, BUILDING):
    # line 4 only (line 5 ships on the date): 500 * 95 = 47,500; order 2
    # is MACHINERY, order 33 is after the date
    assert want["top"] == {"l_orderkey": [1, 3],
                           "o_orderdate": [G.day("1995-03-01"),
                                           G.day("1995-03-10")],
                           "o_shippriority": [0, 0],
                           "revenue": [290000, 47500]}
    got = dict(want["top"])
    assert ref.compare(got, want) == {"q3_rows_wrong": 0,
                                      "q3_revenue_gap": 0}
    bad = dict(got, revenue=[290001, 47500])
    assert ref.compare(bad, want) == {"q3_rows_wrong": 1,
                                      "q3_revenue_gap": 1}
    # the joins take in 3 orders before the date and 2 BUILDING
    # customers, then 5 lineitems shipped after it and the 2 orders
    # joined; the order-by gets one row for each of orders 1 and 3
    assert want["sizes"] == {"joins": [[2, 3], [2, 5]], "groups": 2}
    log = [{"label": "join", "recv_rows": [[2, 1], [1, 1]]},
           {"label": "join", "recv_rows": [[3, 2], [0, 2]]},
           {"label": "groupby", "recv_rows": [[1, 1]]},
           {"label": "orderby", "recv_rows": [[2, 0]]},
           {"label": "output", "recv_rows": []}]
    assert ref.compare_counts(log, want) == {"q3_join_rows_gap": 0,
                                             "q3_groups_gap": 0}
    log[1]["recv_rows"][0] = [3, 1]
    log[3]["recv_rows"][0] = [2, 1]
    assert ref.compare_counts(log, want) == {"q3_join_rows_gap": 1,
                                             "q3_groups_gap": 1}
    # a log without the order-by stage misses by every order
    assert ref.compare_counts(log[:3], want)["q3_groups_gap"] == 2


def test_sort_reference_by_hand():
    ref = bench.load_file(bench.os.path.join(bench.HERE, "reference",
                                             "terasort.py"), "ref_ts_hand")
    keys = [b"b" * 10, b"a" * 9 + b"b", b"a" * 10, b" " * 10, b"a" * 9 + b"a"]
    n, P = len(keys), 2
    k = torch.tensor([list(x) for x in keys], dtype=torch.uint8)
    pay = S.hex_digits(torch.arange(n), 32)
    pay = torch.cat([torch.full((n, 2), 32, dtype=torch.uint8), pay,
                     torch.full((n, 56), 32, dtype=torch.uint8)], 1)
    L = lambda w: T.partitioned(torch.full((n,), w, dtype=torch.int32), P)
    tables = {"records": T.make_table(
        {"key": (T.partitioned(k, P), L(10)),
         "payload": (T.partitioned(pay, P), L(90))}, n, P,
        torch.device("cpu"))}
    want = ref.reference(tables, {})
    # the two equal keys "a" * 10 keep their input order (stable)
    assert [bytes(r.tolist()) for r in want["keys"]] == [
        b" " * 10, b"a" * 10, b"a" * 10, b"a" * 9 + b"b", b"b" * 10]
    order = [3, 2, 4, 1, 0]
    out = {"columns": {"key": (k[order][None], torch.full((1, n), 10)),
                       "payload": (pay[order][None], torch.full((1, n), 90))},
           "counts": torch.tensor([n])}
    assert ref.compare(out, tables, want) == {
        "sort_rows_lost": 0, "sort_keys_misplaced": 0,
        "sort_records_wrong": 0}
    # the tied pair may come in either order
    out2 = {"columns": {"key": (k[[3, 4, 2, 1, 0]][None], torch.full(
        (1, n), 10)), "payload": (pay[[3, 4, 2, 1, 0]][None],
                                  torch.full((1, n), 90))},
            "counts": torch.tensor([n])}
    assert ref.compare(out2, tables, want)["sort_keys_misplaced"] == 0
    swapped = {"columns": {"key": (k[[2, 3, 4, 1, 0]][None], torch.full(
        (1, n), 10)), "payload": (pay[[2, 3, 4, 1, 0]][None],
                                  torch.full((1, n), 90))},
               "counts": torch.tensor([n])}
    assert ref.compare(swapped, tables, want)["sort_keys_misplaced"] == 2
    lost = dict(out, counts=torch.tensor([n - 1]))
    nums = ref.compare(lost, tables, want)
    assert nums["sort_rows_lost"] == 1 and nums["sort_records_wrong"] == 1
