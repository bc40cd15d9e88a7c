"""The port's SQL front end (``dryad_tpu_torch.sql``) against the JAX
package's (``dryad_tpu.sql``) on the same catalogs and query texts.

Every DTA3xx rejection of ``tests/test_sql.py`` gives the same findings
(code, severity, line:column span, message) in both packages; the query
shapes of ``tests/test_sql.py`` give the same rows on the port's CPU
executor (``device="cpu"``, P = 8), under ``Context(local_debug=True)``
and in the JAX package: integers and strings exactly, f32 columns within
16 * 2^-24 * sum|v| of the column (PERF.md §2).  The row-expression
interpreter on the port's four kinds of input, the catalog fingerprint
and the ``sql_query`` / ``sql_lowered`` events across packages, the CLI
(``--device cpu``; plain EXPLAIN with no device), the refusals of what
is not ported, and a CPU rehearsal of ``chip_smoke.py``'s phase 14."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu import sql as jsql
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig, sql
from dryad_tpu_torch.data.columnar import batch_from_numpy
from dryad_tpu_torch.sql.errors import SqlError
from dryad_tpu_torch.sql.rowexpr import Predicate, Projector
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
EPS = 2.0 ** -24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOIN_Q = ("SELECT l.okey, SUM(l.price * l.qty) AS revenue, "
          "COUNT(*) AS n "
          "FROM lineitem l JOIN orders o ON l.okey = o.okey "
          "WHERE o.flag = 1 GROUP BY l.okey")


def _tpch_cols(n_rows=600, n_orders=40, seed=0):
    """tests/test_sql.py's catalog: lineitem (half the rows on okey 0,
    int prices and quantities, a tag string) and orders."""
    rng = np.random.RandomState(seed)
    okey = np.where(rng.rand(n_rows) < 0.5, 0,
                    rng.randint(1, n_orders, n_rows)).astype(np.int32)
    li = {"okey": okey,
          "price": rng.randint(1, 50, n_rows).astype(np.int32),
          "qty": rng.randint(1, 5, n_rows).astype(np.int32),
          "tag": [b"ok" if i % 3 else b"void" for i in range(n_rows)]}
    orders = {"okey": np.arange(n_orders, dtype=np.int32),
              "flag": (np.arange(n_orders) % 2).astype(np.int32)}
    return li, orders


def _catalog(pkg, n_rows=600):
    li, orders = _tpch_cols(n_rows)
    return (pkg.Catalog().register_columns("lineitem", li)
            .register_columns("orders", orders))


def _tctx(**kw):
    return TContext(device="cpu", nparts=P, **kw)


@pytest.fixture(scope="module")
def jctx():
    return JContext()


def _is_float(v) -> bool:
    return (not isinstance(v, list)
            and np.asarray(v).dtype.kind == "f")


def assert_rows(got, want, ordered=False):
    """Row multisets (or lists) equal: integer and string columns exactly,
    float columns within 16 * 2^-24 * sum|v| of ``want``'s column."""
    assert sorted(got) == sorted(want)
    cols = sorted(want)
    tol = {c: 16 * EPS * float(np.abs(np.asarray(want[c],
                                                 np.float64)).sum())
           for c in cols if _is_float(want[c])}

    def rows(t):
        out = list(zip(*[[bytes(x) for x in t[c]] if isinstance(t[c], list)
                         else np.asarray(t[c]).tolist() for c in cols]))
        if ordered:
            return out
        exact = [i for i, c in enumerate(cols) if c not in tol]
        return sorted(out, key=lambda r: ([r[i] for i in exact], r))

    g, w = rows(got), rows(want)
    assert len(g) == len(w), (len(g), len(w))
    for a, b in zip(g, w):
        for c, x, y in zip(cols, a, b):
            if c in tol:
                assert abs(x - y) <= tol[c], (c, x, y)
            else:
                assert x == y, (c, a, b)


# -- DTA3xx: the same findings in both packages -------------------------------

def _numpy_str_catalog(pkg):
    return pkg.Catalog().register_columns(
        "t", {"name": np.array(["aa", "bb", "aa"]),
              "v": np.asarray([1, 2, 4], np.int32)})


def _having_catalog(pkg):
    return (pkg.Catalog()
            .register_columns("a", {"k": np.asarray([1, 2], np.int32),
                                    "x": np.asarray([1, 1], np.int32)})
            .register_columns("b", {"k": np.asarray([1, 2], np.int32),
                                    "y": np.asarray([2, 2], np.int32)}))


_HAVING_BASE = ("SELECT a.k, b.k AS k2, SUM(x) AS s FROM a "
                "JOIN b ON a.x = b.y GROUP BY a.k, b.k ")

# (how, catalog, query, origin): "parse" runs sql.parse, "compile"
# sql.compile_query — tests/test_sql.py:69-178 and its binder regressions
REJECTED = {
    "where_and": ("compile", _catalog,
                  "SELECT okey\nFROM lineitem\nWHERE AND", "<sql>"),
    "unterminated": ("parse", None, "SELECT 'oops FROM t", "<sql>"),
    "bad_char": ("parse", None, "SELECT a ? b FROM t", "<sql>"),
    "origin": ("parse", None, "SELECT FROM t", "report.sql"),
    "subquery": ("parse", None, "SELECT * FROM (SELECT 1) x", "<sql>"),
    "union": ("parse", None, "SELECT a FROM t UNION SELECT a FROM u",
              "<sql>"),
    "cross": ("parse", None, "SELECT a FROM t CROSS JOIN u", "<sql>"),
    "is_null": ("parse", None, "SELECT a FROM t WHERE a IS NULL", "<sql>"),
    "count_distinct": ("parse", None, "SELECT COUNT(DISTINCT a) FROM t",
                       "<sql>"),
    "median": ("parse", None, "SELECT MEDIAN(a) FROM t", "<sql>"),
    "offset": ("parse", None, "SELECT a FROM t LIMIT 5 OFFSET 5", "<sql>"),
    "unknown_table": ("compile", _catalog, "SELECT x FROM nosuch", "<sql>"),
    "unknown_column": ("compile", _catalog,
                       "SELECT okey\nFROM orders\nWHERE bogus = 1", "<sql>"),
    "ambiguous": ("compile", _catalog,
                  "SELECT okey FROM lineitem l JOIN orders o "
                  "ON l.okey = o.okey", "<sql>"),
    "types_at_once": ("compile", _catalog,
                      "SELECT SUM(tag) AS s, MAX(qty) AS m\n"
                      "FROM lineitem\nWHERE price = 'cheap' AND "
                      "qty + tag > 3", "<sql>"),
    "non_grouped": ("compile", _catalog,
                    "SELECT price, SUM(qty) AS q FROM lineitem "
                    "GROUP BY okey", "<sql>"),
    "having_no_group": ("compile", _catalog,
                        "SELECT okey FROM lineitem HAVING okey > 1",
                        "<sql>"),
    "join_non_equi": ("compile", _catalog,
                      "SELECT l.okey FROM lineitem l JOIN orders o "
                      "ON l.okey > o.okey", "<sql>"),
    "order_not_output": ("compile", _catalog,
                         "SELECT okey FROM orders ORDER BY flag", "<sql>"),
    "numpy_str_vs_int": ("compile", _numpy_str_catalog,
                         "SELECT v FROM t WHERE name = 5", "<sql>"),
    "having_ambiguous": ("compile", _having_catalog,
                         _HAVING_BASE + "HAVING k > 0", "<sql>"),
    "emit_inline": ("compile", _catalog,
                    "SELECT okey FROM lineitem EMIT EVERY 0", "<sql>"),
}


def _findings(pkg, how, make_cat, query, origin):
    with pytest.raises(Exception) as ei:
        if how == "parse":
            pkg.parse(query, origin=origin)
        else:
            pkg.compile_query(make_cat(pkg), query, origin=origin)
    assert type(ei.value).__name__ == "SqlError"
    return ei.value.code, [(d.code, d.severity, str(d.span), d.message)
                           for d in ei.value.report.sorted()]


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejections_match_jax(case):
    """Each rejected query: the same first code and the same findings
    (code, severity, origin:line:column, message) in both packages."""
    got = _findings(sql, *REJECTED[case])
    want = _findings(jsql, *REJECTED[case])
    assert got == want
    assert all(d[2].count(":") == 2 for d in got[1])   # line:column


def test_rejection_spans_are_the_jax_tests():
    """Spot values of tests/test_sql.py, on the port."""
    assert _findings(sql, *REJECTED["where_and"])[1][0][2] == "<sql>:3:7"
    assert _findings(sql, *REJECTED["unknown_table"])[1][0][2] == \
        "<sql>:1:15"
    assert _findings(sql, *REJECTED["origin"])[1][0][2] == "report.sql:1:8"
    assert len(_findings(sql, *REJECTED["types_at_once"])[1]) >= 3
    with pytest.raises(SqlError):
        sql.compile_query(_having_catalog(sql), _HAVING_BASE
                          + "HAVING a.k > 0 AND k2 > 0")
    sql.compile_query(_having_catalog(sql), _HAVING_BASE + "HAVING a.k > 0")


# -- rows: the port's executor, its oracle and the JAX package ---------------

SHAPES = {
    "join_group": (JOIN_Q, False),
    "order_limit": (JOIN_Q + " ORDER BY revenue DESC LIMIT 5", True),
    "scan_str": ("SELECT okey, price FROM lineitem WHERE tag != 'void' "
                 "AND qty > 2", False),
    "distinct": ("SELECT DISTINCT okey FROM lineitem WHERE qty = 3", False),
    "global_agg": ("SELECT COUNT(*) AS n, SUM(price) AS s, AVG(qty) AS aq "
                   "FROM lineitem WHERE tag = 'ok'", False),
    "having": ("SELECT okey, MIN(price) AS lo, MAX(price) AS hi "
               "FROM lineitem GROUP BY okey HAVING lo < hi", False),
    "left_join": ("SELECT o.okey, COUNT(*) AS n FROM orders o "
                  "LEFT JOIN lineitem l ON o.okey = l.okey "
                  "WHERE o.flag = 0 GROUP BY o.okey", False),
    "not_or": ("SELECT okey, price - qty AS margin FROM lineitem "
               "WHERE NOT (qty > 3) OR price <= 2", False),
    "div_float": ("SELECT okey, price / qty AS r, qty * 1.5 AS w "
                  "FROM lineitem WHERE price >= 40", False),
    "order_asc": ("SELECT DISTINCT qty FROM lineitem ORDER BY qty", True),
}


def _literal_catalog(pkg):
    return pkg.Catalog().register_columns(
        "t", {"name": [b"abcd", b"ab", b"abcd"],
              "v": np.asarray([1, 2, 3], np.int32)}, str_max_len=4)


def _const_catalog(pkg):
    return pkg.Catalog().register_columns(
        "t", {"v": np.asarray([1, 2, 3], np.int32)})


SMALL = {
    "const_true": (_const_catalog, "SELECT v FROM t WHERE 1 = 1"),
    "const_not": (_const_catalog, "SELECT v FROM t WHERE NOT (1 = 1)"),
    "long_literal_eq": (_literal_catalog,
                        "SELECT v FROM t WHERE name = 'abcde'"),
    "long_literal_ne": (_literal_catalog,
                        "SELECT v FROM t WHERE name != 'abcde'"),
    "numpy_strings": (_numpy_str_catalog,
                      "SELECT SUM(v) AS s FROM t WHERE name = 'aa'"),
    "str_eq_str": (_literal_catalog,
                   "SELECT a.v FROM t a JOIN t b ON a.v = b.v "
                   "WHERE a.name = b.name"),
}


def _cases():
    out = {k: ((lambda pkg: _catalog(pkg, 300)) if k != "join_group"
               and k != "order_limit" else _catalog, q, ordered)
           for k, (q, ordered) in SHAPES.items()}
    out.update({k: (mk, q, False) for k, (mk, q) in SMALL.items()})
    return out


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_match_jax(jctx, case):
    make_cat, q, ordered = CASES[case]
    got = sql.query(_tctx(), make_cat(sql), q).collect()
    want = jsql.query(jctx, make_cat(jsql), q).collect()
    assert_rows(got, want, ordered=ordered)
    if case == "long_literal_eq":
        assert len(got["v"]) == 0
    if case == "long_literal_ne":
        assert sorted(np.asarray(got["v"]).tolist()) == [1, 2, 3]


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_debug_rows_match(case):
    """The same query through the port's sequential oracle (its
    callables get CPU tensors and lists of bytes) gives the executor's
    rows."""
    make_cat, q, ordered = CASES[case]
    cat = make_cat(sql)
    got = sql.query(_tctx(local_debug=True), cat, q).collect()
    want = sql.query(_tctx(), cat, q).collect()
    assert_rows(got, want, ordered=ordered)


def test_store_backed_table_matches_jax(jctx, tmp_path):
    """A catalog over a store the port wrote: schema and row count from
    the manifest, the same rows as the JAX package reading the same
    store."""
    d = str(tmp_path / "kv")
    _tctx().from_columns({"k": np.arange(64, dtype=np.int32) % 4,
                          "v": np.arange(64, dtype=np.int32)}).to_store(d)
    cat = sql.Catalog().register_store("kv", d)
    assert cat.get("kv").rows == 64
    assert cat.fingerprint() == \
        jsql.Catalog().register_store("kv", d).fingerprint()
    q = "SELECT k, SUM(v) AS s FROM kv GROUP BY k"
    got = sql.query(_tctx(), cat, q).collect()
    want = jsql.query(jctx, jsql.Catalog().register_store("kv", d),
                      q).collect()
    assert_rows(got, want)
    assert_rows(got, {"k": np.arange(4, dtype=np.int32),
                      "s": np.asarray([sum(range(k, 64, 4))
                                       for k in range(4)], np.int32)})


def test_adaptive_rewrite_on_skewed_sql_query():
    """tests/test_sql.py's stressor on the port: a skewed group + order
    through SQL rewrites at least once with adaptive on, with the rows of
    adaptive off."""
    rng = np.random.RandomState(1)
    n = 20_000
    cat = sql.Catalog().register_columns("lineitem", {
        "okey": np.where(rng.rand(n) < 0.9, 0,
                         rng.randint(1, 500, n)).astype(np.int32),
        "price": rng.randint(1, 100, n).astype(np.int32)})
    q = ("SELECT okey, SUM(price) AS s FROM lineitem GROUP BY okey "
         "ORDER BY s DESC")
    ev = EventLog()
    on = sql.query(_tctx(event_log=ev, config=JobConfig(adaptive="on")),
                   cat, q).collect()
    off = sql.query(_tctx(), cat, q).collect()
    assert ev.of_type("graph_rewrite")
    assert_rows(on, off)


# -- catalog and events across packages ---------------------------------------

@pytest.mark.parametrize("kind", ["tpch", "numpy_str", "schema",
                                  "max_len", "reordered"])
def test_catalog_fingerprint_matches_jax(kind):
    def make(pkg):
        if kind == "tpch":
            return _catalog(pkg)
        if kind == "numpy_str":
            return _numpy_str_catalog(pkg)
        if kind == "max_len":
            return _literal_catalog(pkg)
        if kind == "reordered":
            li, _ = _tpch_cols()
            return pkg.Catalog().register_columns(
                "lineitem", {k: li[k] for k in reversed(list(li))})
        return pkg.Catalog.load(os.path.join(ROOT, "docs", "plans",
                                             "sql_catalog.json"))
    assert make(sql).fingerprint() == make(jsql).fingerprint()
    if kind == "reordered":
        li, _ = _tpch_cols()
        assert make(sql).fingerprint() == \
            sql.Catalog().register_columns("lineitem", li).fingerprint()


def test_catalog_save_load_round_trip(tmp_path):
    """save / load keeps schema, str_max_len, non-UTF-8 bytes and the
    fingerprint, and the JAX package loads the port's file to the same
    fingerprint."""
    cat = sql.Catalog().register_columns(
        "t", {"s": [b"ab", b"\xff\x00cd"], "v": np.asarray([1, 2], np.int32)},
        str_max_len=32)
    p = str(tmp_path / "cat.json")
    cat.save(p)
    back = sql.Catalog.load(p)
    assert back.get("t").schema == cat.get("t").schema
    assert back.get("t").str_max_len == 32
    assert back.get("t").columns["s"] == [b"ab", b"\xff\x00cd"]
    assert back.fingerprint() == cat.fingerprint() == \
        jsql.Catalog.load(p).fingerprint()


def test_sql_events_match_jax(jctx):
    """``sql_query`` (normalized text, catalog fingerprint, tables) and
    ``sql_lowered`` are the JAX package's events."""
    def events(pkg, ctx):
        ev = []
        pkg.query(ctx, _catalog(pkg), JOIN_Q + " ORDER BY n LIMIT 3",
                  event=ev.append)
        return ev
    got, want = events(sql, _tctx()), events(jsql, jctx)
    assert [e["event"] for e in got] == ["sql_query", "sql_lowered"]
    assert got == want
    assert got[0]["query"] == sql.normalize_query(JOIN_Q + " ORDER BY n "
                                                  "LIMIT 3")


def test_context_event_log_gets_sql_and_plan_events():
    ev = EventLog()
    sql.query(_tctx(event_log=ev), _catalog(sql), JOIN_Q).collect()
    kinds = [e["event"] for e in ev.events]
    assert kinds[:2] == ["sql_query", "sql_lowered"]
    assert kinds.count("plan") == 1


# -- row expressions on the port's inputs -------------------------------------

def test_rowexpr_ship_round_trip_and_content_identity():
    from dryad_tpu_torch.plan.serialize import ship_ref_of
    p = Predicate(["bin", ">", ["col", "v"], ["lit", 3, "int"]])
    assert ship_ref_of(p) == "dryad_tpu_torch.sql.rowexpr:Predicate"
    p2 = Predicate.__from_payload__(p.__ship_payload__())
    assert p2 == p and hash(p2) == hash(p)
    cols = {"v": torch.tensor([1, 5, 7, 2], dtype=torch.int32)}
    assert p(cols).tolist() == [False, True, True, False]
    assert p(cols).dtype == torch.bool
    pr = Projector({"d": ["bin", "*", ["col", "v"], ["lit", 2, "int"]]})
    assert Projector.__from_payload__(
        pr.__ship_payload__())(cols)["d"].tolist() == [2, 10, 14, 4]


ARITH = {"div_ii": ["bin", "/", ["col", "a"], ["col", "b"]],
         "div_lit": ["bin", "/", ["col", "a"], ["lit", 2, "int"]],
         "mul_if": ["bin", "*", ["col", "a"], ["col", "f"]],
         "mul_weak_float": ["bin", "*", ["col", "a"], ["lit", 1.5, "float"]],
         "add_weak_int": ["bin", "+", ["col", "a"], ["lit", 7, "int"]],
         "sub_fi": ["bin", "-", ["col", "f"], ["lit", 3, "int"]],
         "neg": ["neg", ["col", "a"]],
         "cmp": ["bin", "<=", ["col", "f"], ["col", "a"]]}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_rowexpr_promotion_matches_jnp(name):
    """int32 / int32 is float32, int32 * float32 float32, a Python
    literal weak: the port's dtype and values are the JAX program's on
    the same numpy inputs (jnp with x64 off)."""
    import jax.numpy as jnp
    from dryad_tpu.sql.rowexpr import Projector as JProjector
    rng = np.random.RandomState(3)
    a = rng.randint(-20, 20, 50).astype(np.int32)
    b = rng.randint(1, 9, 50).astype(np.int32)
    f = (rng.rand(50) * 10).astype(np.float32)
    got = Projector({"o": ARITH[name]})({"a": torch.from_numpy(a),
                                         "b": torch.from_numpy(b),
                                         "f": torch.from_numpy(f)})["o"]
    want = np.asarray(JProjector({"o": ARITH[name]})(
        {"a": jnp.asarray(a), "b": jnp.asarray(b), "f": jnp.asarray(f)})["o"])
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=EPS, atol=0)


def test_rowexpr_strings_on_every_input():
    """String equality and a constant column on a StringColumn, on meta
    tensors (shape only, nothing materialized), and on host lists of
    bytes beside a CPU tensor: a bool tensor on the input's device each
    time."""
    eq = Predicate(["bin", "and", ["bin", "!=", ["col", "tag"],
                                   ["lit", "void", "str"]],
                    ["bin", ">", ["col", "v"], ["lit", 1, "int"]]])
    host = {"tag": [b"ok", b"void", b"ok", b"ok"],
            "v": torch.tensor([5, 5, 0, 3], dtype=torch.int32)}
    assert eq(host).tolist() == [True, False, False, True]
    b = batch_from_numpy({"tag": host["tag"],
                          "v": np.asarray([5, 5, 0, 3], np.int32)},
                         str_max_len=8, device="cpu")
    assert eq(b.columns).tolist() == [True, False, False, True]
    meta = {"tag": type(b.columns["tag"])(
        torch.empty(4, 8, dtype=torch.uint8, device="meta"),
        torch.empty(4, dtype=torch.int32, device="meta")),
        "v": torch.empty(4, dtype=torch.int32, device="meta")}
    m = eq(meta)
    assert m.device.type == "meta" and m.dtype == torch.bool
    assert tuple(m.shape) == (4,)
    key = Projector({"k": ["const", 0, "int"]})(meta)["k"]
    assert key.device.type == "meta" and key.dtype == torch.int32
    assert Predicate(["bin", "=", ["lit", 1, "int"],
                      ["lit", 1, "int"]])(host).tolist() == [True] * 4
    assert Predicate(["not", ["bin", "=", ["lit", 1, "int"], ["lit", 1,
                                                               "int"]]])(
        meta).device.type == "meta"


# -- plans --------------------------------------------------------------------

def test_sql_plan_round_trips_with_no_fn_table_and_runs():
    """A SQL plan's callables are all data: graph_to_json -> graph_from_json
    with an empty fn_table rebuilds it (same fingerprints), and the
    rebuilt graph runs to the rows of collect()."""
    from dryad_tpu_torch.exec.data import pdata_to_host
    from dryad_tpu_torch.plan.serialize import graph_from_json, graph_to_json
    ctx = _tctx()
    ds = sql.query(ctx, _catalog(sql), JOIN_Q)
    graph = ds.plan()
    js = graph_to_json(graph)
    assert '"__fn__"' not in js and '"__opaque__"' not in js
    srcs = {f"{st.id}:{i}": leg.src[1] for st in graph.stages
            for i, leg in enumerate(st.legs)
            if isinstance(leg.src, tuple) and leg.src[0] == "source"}
    g2 = graph_from_json(js, fn_table={}, sources=srcs)
    assert [s.fingerprint() for s in g2.stages] == \
        [s.fingerprint() for s in graph.stages]
    assert graph_to_json(g2) == js
    assert_rows(pdata_to_host(ctx.executor.run(g2)), ds.collect())
    # a re-lowered query fingerprints the same (content, not identity)
    g3 = sql.query(ctx, _catalog(sql), JOIN_Q).plan()
    assert [s.fingerprint() for s in g3.stages] == \
        [s.fingerprint() for s in graph.stages]
    # the source slots map back to the catalog's tables
    _mode, bound = sql.compile_query(_catalog(sql), JOIN_Q)
    ds4, handles = sql.lower(ctx, _catalog(sql), bound)
    assert sorted(sql.source_tables(ds4.plan(), handles).values()) == \
        ["lineitem", "orders"]


def test_offline_plans_need_no_device(monkeypatch):
    """offline_explain / offline_plan_json and a SchemaContext lowering
    never resolve a device: with resolve_device refusing every call they
    still run, over a schema-only catalog."""
    import dryad_tpu_torch.api.dataset as tds
    import dryad_tpu_torch.parallel.mesh as tmesh
    ctx = _tctx()

    def refuse(*a, **k):
        raise AssertionError("offline planning resolved a device")
    monkeypatch.setattr(tmesh, "resolve_device", refuse)
    monkeypatch.setattr(tds, "resolve_device", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = sql.Catalog.load(os.path.join(ROOT, "docs", "plans",
                                        "sql_catalog.json"))
    q = open(os.path.join(ROOT, "docs", "plans", "sql_join_revenue.sql")
             ).read()
    text = sql.offline_explain(cat, q)
    assert "stage0 <join>" in text and "output: stage3" in text
    assert json.loads(sql.offline_plan_json(cat, q))["out_stage"] == 3
    with pytest.raises(sql.SchemaOnlyTableError):
        sql.query(ctx, cat, q)


# -- refusals: what is not ported, and no CPU fallback -------------------------

def test_unported_statements_refuse(devices8, tmp_path):
    """EMIT EVERY runs through ``sql.query`` as one batch query, as in the
    JAX package (its rows equal the JAX package's), and ``sql.explain`` /
    ``offline_explain`` append the JAX package's refresh verdict; the
    catalog's watermark surface answers as the JAX package's; EXPLAIN
    ANALYZE runs (it executes the query once and appends the measured
    actuals); a plain EXPLAIN builds no dataset."""
    cat = _catalog(sql)
    text = sql.explain(_tctx(), cat, "EXPLAIN ANALYZE " + JOIN_Q)
    assert "EXPLAIN ANALYZE (executed):" in text
    assert "0 cost-model miss(es)" in text
    path = str(tmp_path / "s")
    _tctx().from_columns(_tpch_cols()[0]).to_store(path)
    cat.register_store("s", path)
    jcat = _catalog(jsql).register_store("s", path)
    q = "SELECT okey, SUM(qty) AS q FROM s GROUP BY okey EMIT EVERY 5"
    got = sql.query(_tctx(), cat, q).collect()
    want = jsql.query(JContext(), jcat, q).collect()
    assert sorted(zip(got["okey"].tolist(), got["q"].tolist())) == \
        sorted(zip(np.asarray(want["okey"]).tolist(),
                   np.asarray(want["q"]).tolist()))
    for ex in (lambda pkg, c: pkg.offline_explain(c, q),
               lambda pkg, c: pkg.explain(
                   _tctx() if pkg is sql else JContext(), c, q)):
        t, j = ex(sql, cat), ex(jsql, jcat)
        assert t[t.index("standing query:"):] == j[j.index(
            "standing query:"):]
        assert "DTA401" in t
    assert cat.watermark("s") == jcat.watermark("s") == 0
    assert cat.parts_since("s", -1) == jcat.parts_since("s", -1) == \
        list(range(P))
    with pytest.raises(ValueError, match="explain"):
        sql.query(_tctx(), cat, "EXPLAIN " + JOIN_Q)


def test_query_without_cuda_raises(monkeypatch):
    """The default Context is the card's: with no CUDA a SQL query has no
    Context to run in (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sql.query(TContext(), _catalog(sql), JOIN_Q)


def test_explain_cost_runs_nothing():
    """EXPLAIN COST: the plan, the diagnostics (no error) and the cost
    table, with no executor run."""
    ctx = _tctx()
    ctx.executor.run = lambda *a, **k: pytest.fail("EXPLAIN ran the plan")
    text = sql.explain(ctx, _catalog(sql), "EXPLAIN COST " + JOIN_Q)
    assert "diagnostics:" in text and "predicted cost:" in text
    assert "0 error(s)" in text
    assert sql.explain(ctx, _catalog(sql), "EXPLAIN " + JOIN_Q) == \
        sql.query(ctx, _catalog(sql), JOIN_Q).explain()


# -- the CLI ------------------------------------------------------------------

def _cli(args, **kw):
    return subprocess.run([sys.executable, "-m", "dryad_tpu_torch.sql",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, **kw)


def test_cli_offline_explain_needs_no_device(tmp_path):
    """Plain EXPLAIN over the schema-only catalog with the default
    --device cuda on a machine without a card; a DTA3xx error exits 2;
    --plan-json prints the golden plan."""
    cat = os.path.join(ROOT, "docs", "plans", "sql_catalog.json")
    out = _cli(["--catalog", cat, "-e", "EXPLAIN SELECT okey, qty FROM "
                "lineitem WHERE qty > 2"])
    assert out.returncode == 0, out.stderr
    assert "output: stage" in out.stdout
    out = _cli(["--catalog", cat, "-e", "SELECT bogus FROM lineitem"])
    assert out.returncode == 2 and "DTA303" in out.stderr
    out = _cli(["--catalog", cat, "--plan-json", "-f",
                os.path.join(ROOT, "docs", "plans", "sql_scan_topk.sql")])
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["stages"][1]["label"] == "orderby"
    # EXPLAIN ANALYZE executes: over a schema-only table it has no data
    # to run on (exit 3, the table named), never "not ported"
    out = _cli(["--catalog", cat, "--device", "cpu", "-e",
                "EXPLAIN ANALYZE SELECT okey FROM lineitem"],
               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and "lineitem" in out.stderr
    assert "not ported" not in out.stderr


def test_cli_executes_with_device_cpu(tmp_path):
    """A SELECT over an inline catalog runs with --device cpu and prints
    the JAX package's rows; without --device it needs the card."""
    p = str(tmp_path / "cat.json")
    _catalog(sql).save(p)
    q = "SELECT okey, COUNT(*) AS n FROM lineitem GROUP BY okey ORDER BY okey"
    out = _cli(["--catalog", p, "--device", "cpu", "-e", q],
               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "okey | n"
    want = jsql.query(JContext(), _catalog(jsql), q).collect()
    assert lines[2:2 + len(want["okey"])] == [
        f"{k} | {n}" for k, n in zip(want["okey"], want["n"])]
    out = _cli(["--catalog", p, "--device", "cpu", "-e", "EXPLAIN COST " + q])
    assert out.returncode == 0 and "predicted cost:" in out.stdout
    out = _cli(["--catalog", p, "--device", "cpu", "-e",
                "EXPLAIN ANALYZE " + q],
               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert "EXPLAIN ANALYZE (executed):" in out.stdout
    assert "0 cost-model miss(es)" in out.stdout
    if not torch.cuda.is_available():
        out = _cli(["--catalog", p, "-e", q])
        assert out.returncode != 0 and "CUDA is not available" in out.stderr


# -- chip_smoke.py's phase 14, rehearsed on the CPU ---------------------------

def test_chip_smoke_phase14_rehearsal(monkeypatch):
    """chip_smoke.py's phase 14 on the CPU at 30,000 lineitems (the card's
    synchronize stubbed, no profile) with every plain kernel version
    bumping its launch counter: every cell equals its oracle, the plan /
    lint / cost events hold, EXPLAIN COST launches nothing and predicts
    the run's capacities, all five kernels launch and every captured
    call is held."""
    import chip_smoke
    from dryad_tpu_torch.ops import hopper_kernels as hk
    for name, plain in (("hist_buckets", "hist_buckets_batched_plain"),
                        ("prefix_sum", "prefix_sum_plain"),
                        ("prefix_sum2", "prefix_sum2_plain"),
                        ("slot_expand", "slot_expand_batched_plain"),
                        ("slot_compact", "slot_compact_batched_plain")):
        real = getattr(hk, plain)

        def bump(*a, _real=real, _name=name):
            if a[0].device.type != "meta":
                hk.launches[_name] += 1
            return _real(*a)
        monkeypatch.setattr(hk, plain, bump)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: TContext(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    out = chip_smoke.phase14_runs(port, hk, 30_000, held)
    assert sorted(out) == ["sqlgolden_join6m", "sqlgolden_scan6m",
                           "sqlq1agg6m", "sqlq3_6m_off", "sqlq3_6m_on"]
    assert out["sqlq3_6m_on"]["rewrites"] and \
        not out["sqlq3_6m_off"]["rewrites"]
    assert out["sqlq3_6m_on"]["rows_equal_off"]
    for line in out.values():
        assert line["capacities"] == [3_750] * len(line["capacities"])
        assert "DTA205" in line["lint"]
        assert len(line["warm"]) >= 1
    launched = {k: sum(r[0][k] for r in runs.values())
                for k in chip_smoke.TPU_KERNEL}
    assert all(launched.values()), launched
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
