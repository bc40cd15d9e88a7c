"""The port's plan equivalence (``analysis/canon.py``, ``subsume.py``) and
the analyzer's selfcheck against the JAX package's on the same numpy
catalogs: canonical programs, the committed canonical forms byte for
byte, semantic fingerprints, scan prefixes and share verdicts over
``tests/test_canon.py``'s query sweep, DAG fingerprint equivalence
classes, source content fingerprints, and ``python -m
dryad_tpu_torch.analysis --selfcheck``."""

import dataclasses
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu import sql as jsql
from dryad_tpu.analysis import canon as jcanon
from dryad_tpu.analysis import subsume as jsub
from dryad_tpu.analysis.diagnostics import render_code_table as \
    j_render_code_table
from dryad_tpu.sql import rowexpr as jrx
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import sql
from dryad_tpu_torch.analysis import canon, subsume
from dryad_tpu_torch.analysis.diagnostics import render_code_table
from dryad_tpu_torch.analysis.selflint import scan_package, unused_imports
from dryad_tpu_torch.sql import rowexpr as trx
from tests.test_canon import _DISTINCT_FROM_FIRST, _EQUIV_PAIRS
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = os.path.join(ROOT, "docs", "plans")
GOLDEN = ("sql_join_revenue", "sql_scan_topk")

# the sweep: every query of tests/test_canon.py's equivalence pairs and
# false-positive guards, plus joins, grouping, LIMIT / DISTINCT / ORDER BY
SWEEP = sorted({q for pair in _EQUIV_PAIRS for q in pair}
               | set(_DISTINCT_FROM_FIRST) | {
    "SELECT l.okey AS okey FROM lineitem AS l JOIN orders AS o "
    "ON l.okey = o.okey",
    "SELECT l.okey AS okey FROM lineitem AS l LEFT JOIN orders AS o "
    "ON l.okey = o.okey",
    "SELECT l.okey AS okey FROM lineitem AS l",
    "SELECT l.okey AS okey FROM lineitem AS l LIMIT 5",
    "SELECT DISTINCT l.okey AS okey FROM lineitem AS l",
    "SELECT l.okey AS okey FROM lineitem AS l ORDER BY okey",
    "SELECT l.okey AS okey, l.price AS price FROM lineitem AS l "
    "WHERE l.price > 3",
    "SELECT l.okey AS okey FROM lineitem AS l WHERE l.price > 5",
    "SELECT l.okey AS okey FROM lineitem AS l WHERE l.price > 5 "
    "AND l.qty = 2",
    "SELECT l.okey AS okey, COUNT(*) AS n FROM lineitem AS l "
    "GROUP BY l.okey HAVING n > 2",
    "SELECT o.okey AS okey FROM orders AS o",
})


def _cols(n_rows=400, seed=0):
    """tests/test_canon.py's catalog data."""
    rng = np.random.RandomState(seed)
    li = {"okey": rng.randint(0, 30, n_rows).astype(np.int32),
          "price": rng.randint(1, 50, n_rows).astype(np.int32),
          "qty": rng.randint(1, 5, n_rows).astype(np.int32)}
    orders = {"okey": np.arange(30, dtype=np.int32),
              "flag": (np.arange(30) % 2).astype(np.int32)}
    return li, orders


def _cats(seed=0):
    li, orders = _cols(seed=seed)
    return tuple(pkg.Catalog().register_columns("lineitem", dict(li))
                 .register_columns("orders", dict(orders))
                 for pkg in (jsql, sql))


def _bound(pkg, cat, q):
    return pkg.compile_query(cat, q)[1]


# -- canonical programs -------------------------------------------------------

_X3 = ["bin", ">", ["col", "x"], ["lit", 3, "int"]]
_Y1 = ["bin", "=", ["col", "y"], ["lit", 1, "int"]]
PROGS = [
    ["bin", "and", _X3, _Y1],
    ["bin", "and", _Y1, ["bin", "<", ["lit", 3, "int"], ["col", "x"]]],
    ["bin", "and", _X3, _X3],
    ["not", _X3],
    ["not", ["bin", "and", _X3, _Y1]],
    ["not", ["bin", "or", _X3, ["not", _Y1]]],
    ["bin", "<", ["col", "p"], ["bin", "+", ["lit", 2, "int"],
                                ["lit", 3, "int"]]],
    ["bin", "+", ["bin", "+", ["col", "a"], ["col", "b"]], ["col", "c"]],
    ["bin", "+", ["col", "a"], ["bin", "+", ["col", "b"], ["col", "c"]]],
    ["bin", "*", ["col", "q"], ["col", "p"]],
    ["bin", ">=", ["col", "p"], ["lit", 2.5, "float"]],
    ["bin", "!=", ["lit", "x", "str"], ["col", "s"]],
    ["neg", ["bin", "-", ["col", "a"], ["lit", 1, "int"]]],
    ["lit", True, "bool"],
]


@pytest.mark.parametrize("i", range(len(PROGS)))
def test_canon_prog_and_conjuncts_equal_jax(i):
    prog = PROGS[i]
    assert canon.canon_prog(prog) == jcanon.canon_prog(prog)
    assert canon.conjuncts_of(prog) == jcanon.conjuncts_of(prog)
    assert trx.fold_prog(list(prog)) == jrx.fold_prog(list(prog))


def test_canon_prog_rewrites():
    """The rewrite set itself: commutation, dedup, NNF, folding, and no
    float re-association."""
    assert canon.canon_prog(PROGS[0]) == canon.canon_prog(PROGS[1])
    assert canon.canon_prog(PROGS[2]) == canon.canon_prog(_X3)
    assert canon.canon_prog(PROGS[3]) == \
        ["bin", "<=", ["col", "x"], ["lit", 3, "int"]]
    assert canon.canon_prog(PROGS[6]) == \
        ["bin", "<", ["col", "p"], ["lit", 5, "int"]]
    assert canon.canon_prog(PROGS[7]) != canon.canon_prog(PROGS[8])
    assert canon.conjuncts_of(None) == [] == canon.conjuncts_of(PROGS[13])


# -- the committed canonical forms and bound-SQL fingerprints -----------------

@pytest.mark.parametrize("name", GOLDEN)
def test_canonical_form_golden_byte_for_byte(name):
    cat = sql.Catalog.load(os.path.join(PLANS, "sql_catalog.json"))
    with open(os.path.join(PLANS, name + ".sql")) as f:
        text = f.read()
    _mode, bound = sql.compile_query(cat, text, origin=name + ".sql")
    with open(os.path.join(PLANS, name + ".canon.json")) as f:
        assert canon.canonical_form_json(cat, bound) == f.read()


@pytest.mark.parametrize("q", SWEEP)
def test_fingerprint_prefix_and_form_equal_jax(q):
    jcat, tcat = _cats()
    jb, tb = _bound(jsql, jcat, q), _bound(sql, tcat, q)
    assert canon.canonical_form_json(tcat, tb) == \
        jcanon.canonical_form_json(jcat, jb)
    assert canon.semantic_fingerprint(tcat, tb) == \
        jcanon.semantic_fingerprint(jcat, jb)
    assert canon.scan_prefix(tcat, tb) == jcanon.scan_prefix(jcat, jb)


def test_equivalent_pairs_unify_and_guards_do_not():
    _jcat, tcat = _cats()
    for qa, qb in _EQUIV_PAIRS:
        assert canon.semantic_fingerprint(tcat, _bound(sql, tcat, qa)) \
            == canon.semantic_fingerprint(tcat, _bound(sql, tcat, qb))
    base = canon.semantic_fingerprint(
        tcat, _bound(sql, tcat, _EQUIV_PAIRS[0][0]))
    for q in _DISTINCT_FROM_FIRST:
        assert canon.semantic_fingerprint(tcat, _bound(sql, tcat, q)) \
            != base
    # other table content: another fingerprint
    _j, other = _cats(seed=1)
    q = SWEEP[0]
    assert canon.semantic_fingerprint(tcat, _bound(sql, tcat, q)) != \
        canon.semantic_fingerprint(other, _bound(sql, other, q))


def _verdict(v):
    return None if v is None else (v.code, v.message, v.detail)


@pytest.mark.parametrize("qa", SWEEP)
def test_compare_verdicts_equal_jax(qa):
    """subsume.compare of ``qa`` against every query of the sweep: the
    same DTA501 / DTA502 / DTA503 / None verdict, message and detail as
    the JAX package's."""
    jcat, tcat = _cats()
    ja, ta = _bound(jsql, jcat, qa), _bound(sql, tcat, qa)
    seen = set()
    for qb in SWEEP:
        jv = jsub.compare(jcat, ja, _bound(jsql, jcat, qb))
        tv = subsume.compare(tcat, ta, _bound(sql, tcat, qb))
        assert _verdict(tv) == _verdict(jv), qb
        seen.add(None if tv is None else tv.code)
    assert "DTA501" in seen
    # a standing registration of the same statement is never DTA501
    jv = jsub.compare(jcat, ja, dataclasses.replace(ja, emit_every=5.0))
    tv = subsume.compare(tcat, ta, dataclasses.replace(ta, emit_every=5.0))
    assert _verdict(tv) == _verdict(jv)
    assert tv is None or tv.code != "DTA501"


def test_compare_content_mismatch_is_dta503(monkeypatch):
    """The stale-content arm: one table name, two contents."""
    out = []
    for pkg, mod in ((jsql, jsub), (sql, subsume)):
        a = _cats(seed=0)[pkg is sql]
        b = _cats(seed=1)[pkg is sql]
        qa = _bound(pkg, a, "SELECT l.okey AS okey FROM lineitem AS l "
                            "WHERE l.price > 3")
        qb = _bound(pkg, b, "SELECT l.okey AS okey FROM lineitem AS l "
                            "WHERE l.price > 5")
        pa, pb = mod.scan_prefix(a, qa), mod.scan_prefix(b, qb)
        monkeypatch.setattr(mod, "scan_prefix",
                            lambda c, bnd, qa=qa, pa=pa, pb=pb:
                            pa if bnd is qa else pb)
        out.append(_verdict(mod.compare(a, qa, qb)))
    assert out[0] == out[1] and out[1][0] == "DTA503"


def test_implies_and_bounds_equal_jax():
    conjs = [canon.canon_prog(["bin", op, ["col", c], ["lit", v, "int"]])
             for op, c, v in itertools.product(
                 (">", ">=", "<", "<=", "="), ("x", "y"), (3, 5))]
    conjs.append(canon.canon_prog(["bin", "!=", ["col", "y"],
                                   ["lit", 7, "int"]]))
    sets = [[]] + [[c] for c in conjs] + [list(p) for p in
                                           itertools.combinations(
                                               conjs[::5], 2)]
    for p in sets:
        tb, tr = subsume.bounds_of(p)
        jb, jr = jsub.bounds_of(p)
        assert tr == jr
        assert {k: (v.iv.lo, v.iv.hi, v.lo_strict, v.hi_strict)
                for k, v in tb.items()} == \
            {k: (v.iv.lo, v.iv.hi, v.lo_strict, v.hi_strict)
             for k, v in jb.items()}
        for q in sets:
            assert subsume.implies(p, q) == jsub.implies(p, q)


# -- Dataset DAG fingerprints -------------------------------------------------

def _dags(pkg_ctx, rx):
    """Eight small DAGs over one source: equal and unequal pairs by
    predicate canonicalization, constants, projections and operators."""
    base = pkg_ctx.from_columns({"x": np.arange(16, dtype=np.int32),
                                 "y": np.arange(16, dtype=np.int32) % 3})
    p1 = rx.Predicate(["bin", "and", _X3, _Y1])
    p2 = rx.Predicate(["bin", "and", _Y1,
                       ["bin", "<", ["lit", 3, "int"], ["col", "x"]]])
    p3 = rx.Predicate(["bin", ">", ["col", "x"], ["lit", 4, "int"]])
    px = rx.Projector({"x": ["col", "x"]})
    pxy = rx.Projector({"x": ["col", "x"], "y": ["col", "y"]})
    pyx = rx.Projector({"y": ["col", "y"], "x": ["col", "x"]})
    return [base.where(p1).select(px), base.where(p2).select(px),
            base.where(p3).select(px), base.where(p1).select(pxy),
            base.where(p1).select(pyx), base.where(p1),
            base.where(p2), base.where(p1).select(px).distinct()]


def _classes(fps):
    return sorted(sorted(i for i, g in enumerate(fps) if g == f)
                  for f in set(fps))


def test_node_fingerprint_classes_equal_jax(devices8):
    tdags = _dags(TContext(device="cpu", nparts=8, local_debug=True), trx)
    jdags = _dags(JContext(local_debug=True), jrx)
    tfp = [canon.node_fingerprint(d.node) for d in tdags]
    jfp = [jcanon.node_fingerprint(d.node) for d in jdags]
    assert _classes(tfp) == _classes(jfp)
    assert [0, 1] in _classes(tfp) and [3, 4] in _classes(tfp)
    for a, b in itertools.combinations(range(len(tdags)), 2):
        tv = subsume.dataset_share_verdict(tdags[a].node, tdags[b].node)
        jv = jsub.dataset_share_verdict(jdags[a].node, jdags[b].node)
        assert (tv is None) == (jv is None)
        if tv is not None:
            assert tv.code == jv.code == "DTA501"
    # the per-node map covers every node of the DAG
    fps = canon.dag_fingerprints(tdags[7].node)
    assert tdags[7].node.id in fps and len(set(fps.values())) == len(fps)


def _stamp(cols):
    import time
    return {"x": cols["x"], "t": time.time()}


def test_nondeterministic_udf_refuses_sharing(devices8):
    out = []
    for ctx in (TContext(device="cpu", nparts=8, local_debug=True),
                JContext(local_debug=True)):
        bad = ctx.from_columns({"x": np.arange(16, dtype=np.int32)}) \
            .select(_stamp)
        mod = subsume if isinstance(ctx, TContext) else jsub
        v = mod.dataset_share_verdict(bad.node, bad.node)
        out.append((v.code, v.detail["findings"]))
    assert out[0] == out[1] and out[0][0] == "DTA503"
    assert "DTA101" in out[0][1]


def test_source_fp_of_host_columns_equals_jax():
    """Host columns hash as numpy gives their bytes, in both packages;
    a tensor column (here on the CPU; a CUDA one is read to the host
    once) hashes as the numpy array it holds."""
    rng = np.random.RandomState(3)
    host = {"i": rng.randint(-9, 9, 100).astype(np.int32),
            "f": rng.rand(100).astype(np.float32),
            "s": [b"ab", b"", b"xyz"] * 10,
            "t": ["p", "q"] * 5}
    assert canon._source_fp(None, host) == jcanon._source_fp(None, host)
    tens = {**host, "i": torch.from_numpy(host["i"]),
            "f": torch.from_numpy(host["f"])}
    assert canon._source_fp(None, tens) == canon._source_fp(None, host)
    other = {**host, "i": host["i"] + 1}
    assert canon._source_fp(None, other) != canon._source_fp(None, host)
    assert canon._source_fp(object(), None).startswith("opaque:")


# -- the analyzer's selfcheck -------------------------------------------------

def test_render_code_table_equals_the_committed_docs():
    with open(os.path.join(ROOT, "docs", "diagnostics.md")) as f:
        assert render_code_table() == f.read() == j_render_code_table()


def test_selflint_scan(tmp_path):
    assert scan_package() == []
    p = tmp_path / "m.py"
    p.write_text("import os\nimport sys  # noqa\nimport json\n"
                 "__all__ = ['json']\ntry:\n    import re\n"
                 "except ImportError:\n    pass\n")
    assert [f[2] for f in unused_imports(p)] == ["os"]


def test_selfcheck_cli_exits_0():
    out = subprocess.run([sys.executable, "-m", "dryad_tpu_torch.analysis",
                          "--selfcheck"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for line in ("selflint (unused imports): clean",
                 "docs/diagnostics.md: in sync",
                 "sql goldens: 2 committed",
                 "canon goldens: 2 committed",
                 "docs/observability.md: covers every obs subcommand",
                 "analyzer smoke: 4 committed plan(s) ok"):
        assert line in out.stdout
    assert "--write-docs" not in subprocess.run(
        [sys.executable, "-m", "dryad_tpu_torch.analysis", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120).stdout
