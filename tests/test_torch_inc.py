"""The port's incremental queries (``inc/``, store generations, the
catalog watermark, ``EMIT EVERY`` through ``sql``) against the JAX
package's on the same numpy inputs (mirrors the non-service cases of
``tests/test_inc.py``).

Each package writes and grows its own store from the same columns; every
refresh of the port is held to the JAX ``run_refresh`` on the other store
(mode, code, delta partitions and rows, the ``inc_*`` events but their
seconds and state paths, the result rows) and to a full rescan of the
port's store.  Tolerance: none — the values are integers, and a mean is
``sum.astype(float32) / count`` in both.  State files and appended
manifests cross between the packages."""

import collections
import os

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu import sql as jsql
from dryad_tpu.inc import state as jstate
from dryad_tpu.inc.refresh import _merge_state as j_merge_state
from dryad_tpu.inc.refresh import run_refresh as j_run_refresh
from dryad_tpu.io.store import append_store as j_append_store
from dryad_tpu.io.store import read_store as j_read_store
from dryad_tpu.io.store import store_meta as j_store_meta
from dryad_tpu.exec.data import pdata_to_host as j_pdata_to_host
from dryad_tpu.obs.analyze import analyze_events as j_analyze_events
from dryad_tpu.obs.metrics import Registry as JRegistry
from dryad_tpu.obs.metrics import metrics_from_events as j_metrics
from dryad_tpu.utils.events import EventLog as JEventLog
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import sql
from dryad_tpu_torch.exec.data import pdata_to_host
from dryad_tpu_torch.inc import plan_delta, run_refresh
from dryad_tpu_torch.inc import state as inc_state
from dryad_tpu_torch.inc.delta_plan import render_verdict
from dryad_tpu_torch.inc.refresh import _merge_state, table_payload
from dryad_tpu_torch.io.store import (append_store, parts_since, read_store,
                                      store_generation, store_meta)
from dryad_tpu_torch.obs.analyze import analyze_events
from dryad_tpu_torch.obs.metrics import Registry, metrics_from_events
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


@pytest.fixture(scope="module")
def tctx():
    return TContext(device="cpu", nparts=P, install_trace=False)


@pytest.fixture(scope="module")
def jctx(devices8):
    return JContext(install_trace=False)


def _cols(n, seed, n_keys=5, width=100):
    r = np.random.RandomState(seed)
    return {"k": r.randint(0, n_keys, n).astype(np.int32),
            "v": r.randint(0, width, n).astype(np.int32)}


def _rows(table):
    pay = table_payload(table)["table"]
    names = sorted(pay)
    return sorted(zip(*[pay[c] for c in names])) if names else []


class _Pair:
    """The same store grown by both packages: ``tp`` the port's, ``jp``
    the JAX package's."""

    def __init__(self, tctx, jctx, tmp, cols, name="t"):
        self.tctx, self.jctx, self.name = tctx, jctx, name
        self.tp, self.jp = str(tmp / "tstore"), str(tmp / "jstore")
        self.tsd, self.jsd = str(tmp / "tstate"), str(tmp / "jstate")
        tctx.from_columns(cols).to_store(self.tp)
        jctx.from_columns(cols).to_store(self.jp)
        self.tcat = sql.Catalog().register_store(name, self.tp)
        self.jcat = jsql.Catalog().register_store(name, self.jp)

    def append(self, cols):
        gt = append_store(self.tp, self.tctx.from_columns(cols).node.data)
        gj = j_append_store(self.jp, self.jctx.from_columns(cols).node.data)
        assert gt == gj
        return gt

    def refresh(self, q, tlog=None, jlog=None):
        """Both packages' refresh of ``q``, held to each other."""
        tb = sql.compile_query(self.tcat, q)[1]
        jb = jsql.compile_query(self.jcat, q)[1]
        t = run_refresh(self.tctx, self.tcat, tb, sql.normalize_query(q),
                        self.tsd, event=tlog)
        j = j_run_refresh(self.jctx, self.jcat, jb,
                          jsql.normalize_query(q), self.jsd, event=jlog)
        for f in ("mode", "shape", "code", "generation", "watermark",
                  "delta_parts", "delta_rows", "rows", "changed_rows"):
            assert getattr(t, f) == getattr(j, f), f
        assert _rows(t.table) == _rows(j.table)
        assert _rows(t.changed) == _rows(j.changed)
        return t

    def full(self, q):
        """A full rescan of ``q`` (EMIT EVERY dropped) over the port's
        store."""
        plain = q.replace(" EMIT EVERY 1", "")
        return sql.query(TContext(device="cpu", nparts=P,
                                  install_trace=False),
                         sql.Catalog().register_store(self.name, self.tp),
                         plain).collect()


def _events(log, kinds=("inc_refresh", "inc_state_write",
                        "inc_fallback_rescan")):
    """The inc_* events but their times and state paths."""
    return [{k: v for k, v in e.items()
             if k not in ("wall_s", "path", "ts")}
            for e in log.events if e.get("event") in kinds]


# -- store generations --------------------------------------------------------

def test_store_generations_and_append(tctx, jctx, tmp_path):
    p = str(tmp_path / "s")
    tctx.from_columns(_cols(16, 1)).to_store(p)
    m = store_meta(p)
    assert store_generation(m) == 0
    assert m["part_generations"] == [0] * m["npartitions"]
    n0 = m["npartitions"]
    assert append_store(p, tctx.from_columns(_cols(6, 2)).node.data) == 1
    m = store_meta(p)
    assert store_generation(m) == 1 and m["npartitions"] > n0
    assert m["part_generations"][:n0] == [0] * n0
    assert set(m["part_generations"][n0:]) == {1}
    assert parts_since(m, 0) == list(range(n0, m["npartitions"]))
    assert parts_since(m, 1) == []
    assert parts_since(m, -1) == list(range(m["npartitions"]))
    host = pdata_to_host(read_store(p, tctx.mesh))
    assert len(host["v"]) == 22
    # the partitions of one generation alone
    part = pdata_to_host(read_store(p, tctx.mesh,
                                    partitions=parts_since(m, 0)))
    assert sorted(part["v"].tolist()) == sorted(_cols(6, 2)["v"].tolist())
    with pytest.raises(ValueError):
        append_store(p, tctx.from_columns(
            {"other": np.arange(3, dtype=np.int32)}).node.data)
    assert store_generation(store_meta(p)) == 1
    assert append_store(p, tctx.from_columns(_cols(0, 3)).node.data) == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_appended_manifests_cross_packages(tctx, jctx, tmp_path, writer):
    """A store appended by one package reads (checksums verified) and
    appends in the other; both packages' manifests of the same appends
    are equal but for the checksum engine's name."""
    pair = _Pair(tctx, jctx, tmp_path, _cols(16, 1))
    pair.append(_cols(6, 2))
    tm, jm = store_meta(pair.tp), j_store_meta(pair.jp)
    assert {k: v for k, v in tm.items() if k != "native_io"} == \
        {k: v for k, v in jm.items() if k != "native_io"}
    src = pair.tp if writer == "port" else pair.jp
    if writer == "port":
        j_append_store(src, jctx.from_columns(_cols(4, 3)).node.data)
    else:
        append_store(src, tctx.from_columns(_cols(4, 3)).node.data)
    got_t = pdata_to_host(read_store(src, tctx.mesh))
    got_j = j_pdata_to_host(j_read_store(src, jctx.mesh))
    want = sorted(np.concatenate([_cols(16, 1)["v"], _cols(6, 2)["v"],
                                  _cols(4, 3)["v"]]).tolist())
    assert sorted(got_t["v"].tolist()) == want
    assert sorted(np.asarray(got_j["v"]).tolist()) == want
    assert store_meta(src)["part_generations"][-1] == 2


def test_append_store_remote_refused(tctx):
    with pytest.raises(NotImplementedError):
        append_store("s3://bucket/store",
                     tctx.from_columns(_cols(4, 1)).node.data)


def test_catalog_watermark_surface(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(8, 1))
    for cat in (pair.tcat, pair.jcat):
        cat.register_columns("inline_t", {"k": np.arange(4, dtype=np.int32)})
    assert pair.tcat.watermark("t") == pair.jcat.watermark("t") == 0
    pair.append(_cols(4, 2))
    assert pair.tcat.watermark("t") == pair.jcat.watermark("t") == 1
    for wm in (-1, 0, 1):
        assert pair.tcat.parts_since("t", wm) == \
            pair.jcat.parts_since("t", wm)
    assert pair.tcat.parts_since("t", 1) == []
    with pytest.raises(ValueError):
        pair.tcat.watermark("inline_t")
    with pytest.raises(ValueError):
        pair.tcat.parts_since("inline_t", 0)
    rows0 = pair.tcat.tables["t"].rows
    pair.tcat.refresh_store("t")
    assert pair.tcat.tables["t"].rows == rows0 + 4


# -- EMIT EVERY through sql ---------------------------------------------------

def test_explain_verdict_equals_jax(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(8, 1))
    for q in ("SELECT k, SUM(v) AS s FROM t GROUP BY k EMIT EVERY 3",
              "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY s DESC "
              "LIMIT 2 EMIT EVERY 3",
              "SELECT k, v FROM t WHERE v > 3 EMIT EVERY 0.5"):
        t = sql.offline_explain(pair.tcat, q)
        j = jsql.offline_explain(pair.jcat, q)
        tv = t[t.index("standing query:"):]
        assert tv == j[j.index("standing query:"):]
        tb, jb = (sql.compile_query(pair.tcat, q)[1],
                  jsql.compile_query(pair.jcat, q)[1])
        assert render_verdict(pair.tcat, tb, plan_delta(pair.tcat, tb)) \
            .replace(pair.tp, pair.jp) == tv.replace(pair.tp, pair.jp)
        live = sql.explain(tctx, pair.tcat, q)
        assert live.endswith(tv)
    good = sql.offline_explain(
        pair.tcat, "SELECT k, SUM(v) AS s FROM t GROUP BY k EMIT EVERY 3")
    assert "-> incremental" in good and "DTA401" in good
    assert "base store 't'" in good
    assert "standing query" not in sql.offline_explain(pair.tcat,
                                                       "SELECT k FROM t")


def test_emit_every_query_runs_as_a_batch_query(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(40, 1))
    q = "SELECT k, SUM(v) AS s, AVG(v) AS a FROM t GROUP BY k EMIT EVERY 1"
    got = sql.query(tctx, pair.tcat, q).collect()
    want = jsql.query(jctx, pair.jcat, q).collect()
    assert _rows(got) == _rows(want)
    assert _rows(got) == _rows(pair.full(q))


# -- the oracle sweeps --------------------------------------------------------

SHAPES = [
    ("group-aggs",
     "SELECT k, SUM(v) AS s, COUNT(*) AS c, AVG(v) AS a, "
     "MIN(v) AS lo, MAX(v) AS hi FROM t GROUP BY k"),
    ("group-sum", "SELECT k, SUM(v) AS s FROM t GROUP BY k"),
    ("global-aggs", "SELECT SUM(v) AS s, COUNT(*) AS c, AVG(v) AS a FROM t"),
]


@pytest.mark.parametrize("label,plain", SHAPES, ids=[s[0] for s in SHAPES])
def test_decomposable_sweep(tctx, jctx, tmp_path, label, plain):
    """Append rounds: every refresh equals the JAX package's and a full
    rescan; the inc_* events equal the JAX package's."""
    pair = _Pair(tctx, jctx, tmp_path, _cols(48, 1))
    q = plain + " EMIT EVERY 1"
    tlog, jlog = EventLog(level=2), JEventLog(level=2)
    for rnd in range(4):
        res = pair.refresh(q, tlog, jlog)
        assert res.mode == "incremental"
        assert _rows(res.table) == _rows(pair.full(q)), (label, rnd)
        pair.append(_cols(12, 10 + rnd))
    assert _events(tlog) == _events(jlog)
    assert len(tlog.of_type("inc_state_write")) == 4
    assert not tlog.of_type("inc_fallback_rescan")


def test_wordcount_sweep(tctx, jctx, tmp_path):
    words = ["the", "quick", "brown", "fox", "dog"]

    def batch(n, seed):
        r = np.random.RandomState(seed)
        return {"word": [words[i] for i in r.randint(0, len(words), n)]}

    pair = _Pair(tctx, jctx, tmp_path, batch(40, 1), name="w")
    q = "SELECT word, COUNT(*) AS n FROM w GROUP BY word EMIT EVERY 1"
    for rnd in range(3):
        res = pair.refresh(q)
        assert _rows(res.table) == _rows(pair.full(q)), rnd
        pair.append(batch(10, 5 + rnd))


def test_append_shape(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(24, 1))
    q = "SELECT k, v FROM t WHERE v >= 50 EMIT EVERY 1"
    plan = plan_delta(pair.tcat, sql.compile_query(pair.tcat, q)[1])
    assert plan.shape == "append" and plan.code == "DTA401"
    seen = []
    for rnd in range(3):
        seen.extend(_rows(pair.refresh(q).table))
        pair.append(_cols(8, 20 + rnd))
    seen.extend(_rows(pair.refresh(q).table))
    assert sorted(seen) == _rows(pair.full(q))
    res = pair.refresh(q)
    assert res.mode == "noop" and res.changed_rows == 0


def test_fallback_rescan(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(32, 1))
    q = ("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY s DESC LIMIT 3 "
         "EMIT EVERY 1")
    plan = plan_delta(pair.tcat, sql.compile_query(pair.tcat, q)[1])
    assert not plan.decomposable and plan.code == "DTA402"
    assert any("ORDER BY" in r for r in plan.reasons)
    tlog, jlog = EventLog(level=2), JEventLog(level=2)
    for rnd in range(2):
        res = pair.refresh(q, tlog, jlog)
        assert (res.mode, res.code) == ("rescan", "DTA402")
        assert _rows(res.table) == _rows(pair.full(q))
        pair.append(_cols(8, 30 + rnd))
    assert _events(tlog) == _events(jlog)
    assert [e["code"] for e in tlog.of_type("inc_fallback_rescan")] == \
        ["DTA402"] * 2


def test_rebuild_cost_rule(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(16, 1))
    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k EMIT EVERY 1"
    tlog, jlog = EventLog(level=2), JEventLog(level=2)
    pair.refresh(q, tlog, jlog)
    pair.append(_cols(48, 2))
    res = pair.refresh(q, tlog, jlog)
    assert (res.mode, res.code) == ("rebuild", "DTA403")
    assert _rows(res.table) == _rows(pair.full(q))
    pair.append(_cols(4, 3))
    res = pair.refresh(q, tlog, jlog)
    assert res.mode == "incremental"
    assert _rows(res.table) == _rows(pair.full(q))
    assert _events(tlog) == _events(jlog)


def test_crash_mid_refresh_no_double_count(tctx, jctx, tmp_path,
                                           monkeypatch):
    pair = _Pair(tctx, jctx, tmp_path, _cols(24, 1))
    q = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k EMIT EVERY 1"
    norm = sql.normalize_query(q)
    pair.refresh(q)
    sp = inc_state.state_path(pair.tsd, inc_state.state_key(
        norm, "t", pair.tp, store_meta(pair.tp)["schema"]))
    before = open(sp, "rb").read()
    pair.append(_cols(8, 2))

    def crash(*a, **kw):
        raise OSError("simulated crash before the atomic commit")

    with monkeypatch.context() as m:
        m.setattr(inc_state, "commit_state", crash)
        with pytest.raises(OSError):
            run_refresh(tctx, pair.tcat, sql.compile_query(pair.tcat, q)[1],
                        norm, pair.tsd)
    assert open(sp, "rb").read() == before
    assert inc_state.load_state(sp)[0] == 0
    res = pair.refresh(q)
    assert res.mode == "incremental" and res.delta_rows == 8
    assert _rows(res.table) == _rows(pair.full(q))


def test_state_commit_atomic_roundtrip(tmp_path):
    sp = str(tmp_path / "state.npz")
    cols = {"k": np.asarray([b"a", b"b"]),
            "s": np.asarray([3, 4], dtype=np.int32)}
    inc_state.commit_state(sp, 7, cols)
    assert os.listdir(tmp_path) == ["state.npz"]
    for load in (inc_state.load_state, jstate.load_state):
        wm, loaded = load(sp)
        assert wm == 7 and loaded["s"].dtype == np.int32
        np.testing.assert_array_equal(loaded["s"], [3, 4])
        assert [bytes(x) for x in loaded["k"]] == [b"a", b"b"]
    jp = str(tmp_path / "j.npz")
    jstate.commit_state(jp, 7, cols)
    wm, loaded = inc_state.load_state(jp)
    assert wm == 7 and [bytes(x) for x in loaded["k"]] == [b"a", b"b"]
    schema = {"v": {"kind": "int32"}}
    for args in (("q", "t", "/p", schema), ("q2", "t", "/p", schema),
                 ("q", "t", "/other", schema)):
        assert inc_state.state_key(*args) == jstate.state_key(*args)
    assert inc_state.state_key("q", "t", "/p", schema) != \
        inc_state.state_key("q2", "t", "/p", schema)
    assert inc_state.load_state(str(tmp_path / "none.npz")) is None


@pytest.mark.parametrize("first", ["port", "jax"])
def test_state_resumes_in_the_other_package(tctx, jctx, tmp_path, first):
    """A state file committed by one package's refresh resumes under the
    other's ``run_refresh`` on the same store: the next refresh merges
    only the delta, equal to a full rescan."""
    p = str(tmp_path / "s")
    sd = str(tmp_path / "state")
    (tctx if first == "port" else jctx).from_columns(
        _cols(40, 1, n_keys=7)).to_store(p)
    q = ("SELECT k, SUM(v) AS s, COUNT(*) AS c, AVG(v) AS a, MIN(v) AS lo "
         "FROM t GROUP BY k EMIT EVERY 1")
    tcat = sql.Catalog().register_store("t", p)
    jcat = jsql.Catalog().register_store("t", p)
    norm = sql.normalize_query(q)
    assert norm == jsql.normalize_query(q)

    def port_refresh():
        return run_refresh(tctx, tcat, sql.compile_query(tcat, q)[1], norm,
                           sd)

    def jax_refresh():
        return j_run_refresh(jctx, jcat, jsql.compile_query(jcat, q)[1],
                             norm, sd)

    a, b = ((port_refresh, jax_refresh) if first == "port"
            else (jax_refresh, port_refresh))
    a()
    append_store(p, tctx.from_columns(_cols(9, 2, n_keys=9)).node.data)
    res = b()
    assert res.mode == "incremental" and res.delta_rows == 9
    want = sql.query(tctx, tcat, q).collect()
    assert _rows(res.table) == _rows(want)
    j_append_store(p, jctx.from_columns(_cols(5, 3, n_keys=9)).node.data)
    res = a()
    assert res.mode == "incremental" and res.delta_rows == 5
    assert _rows(res.table) == _rows(sql.query(tctx, tcat, q).collect())


def test_merge_equals_jax_row_loop():
    """The vectorized merge against the JAX package's row loop: int32
    sums wrap in the engine dtype, min / max keep NaN and signed zeros as
    the row loop does, state rows in first-seen order, the same touched
    rows; string and two-column keys."""
    from dryad_tpu.inc.delta_plan import DeltaPlan as JDeltaPlan
    from dryad_tpu_torch.inc.delta_plan import DeltaPlan
    rng = np.random.RandomState(4)
    for keys in (["k"], ["k", "w"], ["s"]):
        aggs = {"sm": ("sum", "v"), "n": ("count", None),
                "lo": ("min", "f"), "hi": ("max", "f")}
        plans = [cls(True, "aggregate", [], aggs, {}, keys, None, "DTA401")
                 for cls in (DeltaPlan, JDeltaPlan)]

        def table(n):
            t = {"k": rng.randint(0, 6, n).astype(np.int32),
                 "w": rng.randint(0, 2, n).astype(np.int32),
                 "s": [b"x%d" % i for i in rng.randint(0, 6, n)],
                 "sm": rng.randint(2**30, 2**31 - 1, n).astype(np.int32),
                 "n": rng.randint(1, 9, n).astype(np.int32),
                 "f": rng.choice([np.nan, -0.0, 0.0, 1.5, -2.0], n)
                 .astype(np.float32)}
            t["lo"], t["hi"] = t["f"], t["f"].copy()
            # one row per group, as the engine's partial has
            kk = list(zip(*[t[k] for k in keys]))
            first = sorted({x: i for i, x in reversed(list(
                enumerate(kk)))}.values())
            return {c: ([v[i] for i in first] if isinstance(v, list)
                        else v[first]) for c, v in t.items()
                    if c in keys or c in aggs}

        prev = {}
        for _ in range(3):
            part = table(12)
            with np.errstate(over="ignore"):
                jc, jt, jd = j_merge_state(plans[1], prev, part)
                tc, tt = _merge_state(plans[0], prev, part)
            from dryad_tpu.inc.refresh import _state_arrays
            want = _state_arrays(jc, jd)
            assert sorted(tt.tolist()) == sorted(jt)
            for c in want:
                assert np.asarray(tc[c]).tobytes() == want[c].tobytes(), c
            prev = {c: np.asarray(v) for c, v in tc.items()}


def test_inc_events_fold_into_metrics_and_analyze(tctx, jctx, tmp_path):
    pair = _Pair(tctx, jctx, tmp_path, _cols(16, 1))
    q = ("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY s LIMIT 2 "
         "EMIT EVERY 1")
    tlog, jlog = EventLog(level=2), JEventLog(level=2)
    pair.refresh(q, tlog, jlog)
    pair.append(_cols(4, 2))
    pair.refresh(q, tlog, jlog)

    def inc_lines(text):
        return [ln for ln in text.splitlines() if "dryad_inc_" in ln]

    t = inc_lines(metrics_from_events(tlog.events, Registry()).render())
    j = inc_lines(j_metrics(jlog.events, JRegistry()).render())
    assert t == j and any("dryad_inc_refreshes_total 2" in ln for ln in t)
    rep, jrep = analyze_events(tlog.events), j_analyze_events(jlog.events)
    assert (rep.inc_refreshes, rep.inc_fallbacks) == (2, 2)
    assert (jrep.inc_refreshes, jrep.inc_fallbacks) == (2, 2)
    cont = [ln for ln in rep.render().splitlines() if ln.startswith(
        "continuous:")]
    assert cont == [ln for ln in jrep.render().splitlines()
                    if ln.startswith("continuous:")] and cont


# -- standing queries on the port's job service -------------------------------

STANDING_Q = ("SELECT k, SUM(v) AS s, COUNT(*) AS c, MAX(v) AS m FROM t "
              "GROUP BY k EMIT EVERY 0.05")


def _service(tmp, cat):
    from dryad_tpu_torch.service import JobService, ServiceConfig
    return JobService(ServiceConfig(service_dir=str(tmp / "svc"), slots=2,
                                    journal_fsync=False),
                      device="cpu", catalog=cat)


def _refreshed(sq, n, timeout=60.0):
    """The standing query's first ``n`` inc_refresh events, once it has
    refreshed ``n`` times."""
    import time
    t0 = time.time()
    while sq.refreshes < n:
        assert time.time() - t0 < timeout, f"{sq.id}: no refresh {n}"
        time.sleep(0.01)
    return [e for e in sq.log.events if e["event"] == "inc_refresh"][:n]


def _no_stamp(e):
    """An inc_refresh event but its time and the service's stamps."""
    return {k: v for k, v in e.items()
            if k not in ("wall_s", "ts", "job", "tenant", "refresh")}


def test_service_standing_deltas_match_jax(tctx, jctx, tmp_path):
    """A standing query registered through the port's ``submit_sql``: its
    first refresh and one after each of two appends, as ``inc_refresh``
    events on the standing stream, equal the JAX ``run_refresh`` of the
    same statement on the JAX package's copy of the store (mode,
    generation, delta partitions and rows, changed rows, the delta
    itself), each refresh a fair-share ``inc-refresh`` job of the
    tenant, its final table equal to a full rescan."""
    pair = _Pair(tctx, jctx, tmp_path, _cols(40, 1))
    jb = jsql.compile_query(pair.jcat, STANDING_Q)[1]
    svc = _service(tmp_path, pair.tcat)
    try:
        sid = svc.submit_sql(STANDING_Q, tenant="alice")
        sq = svc.standing.get(sid)
        assert sid.startswith("alice-standing-")
        assert svc.status(sid)["standing"] is True
        for step, cols in enumerate((None, _cols(16, 2), _cols(24, 3))):
            if cols is not None:
                pair.append(cols)
            got = _refreshed(sq, step + 1)[step]
            jlog = JEventLog()
            j_run_refresh(pair.jctx, pair.jcat, jb,
                          jsql.normalize_query(STANDING_Q), pair.jsd,
                          event=jlog)
            (want,) = [e for e in jlog.events
                       if e["event"] == "inc_refresh"]
            assert _no_stamp(got) == _no_stamp(want)
            assert got["job"] == sid
        assert got["mode"] == "incremental" and got["delta_rows"] == 24
        jobs = [j for j in svc.list_jobs() if j["app"] == "inc-refresh"]
        assert len(jobs) == 3
        assert all(j["tenant"] == "alice" for j in jobs)
        last = svc.wait(jobs[-1]["job"], timeout=60)["result"]
        assert sorted(zip(*[last["table"][c] for c in sorted(
            last["table"])])) == _rows(pair.full(STANDING_Q.replace(
                " EMIT EVERY 0.05", " EMIT EVERY 1")))
        assert svc.standing_rows()[0]["job"] == sid
    finally:
        svc.close()


def test_service_standing_restart_cancel(tctx, tmp_path):
    """The idle store schedules no refresh; ``crash()`` and an append
    while the daemon is down: the successor restores the registration
    from the journal and its first refresh scans exactly that append;
    ``cancel`` unregisters it for good."""
    import time
    p = str(tmp_path / "s")
    tctx.from_columns(_cols(32, 1)).to_store(p)
    cat = sql.Catalog().register_store("t", p)
    svc = _service(tmp_path, cat)
    sid = svc.submit_sql(STANDING_Q, tenant="bob")
    sq = svc.standing.get(sid)
    _refreshed(sq, 1)
    time.sleep(0.3)
    assert sq.refreshes == 1                    # idle: nothing submitted
    svc.crash()
    append_store(p, tctx.from_columns(_cols(12, 7)).node.data)
    svc2 = _service(tmp_path, sql.Catalog().register_store("t", p))
    try:
        assert svc2.recovery["standing"] == 1
        sq2 = svc2.standing.get(sid)
        (first,) = _refreshed(sq2, 1)
        assert first["mode"] == "incremental"
        assert first["delta_rows"] == 12 and first["delta_parts"] >= 1
        reg = os.path.join(svc2.standing.dir, sid + ".json")
        assert os.path.exists(reg)
        assert svc2.cancel(sid) is True and sq2.log.closed
        assert not os.path.exists(reg) and svc2.cancel(sid) is False
    finally:
        svc2.close()
    svc3 = _service(tmp_path, sql.Catalog().register_store("t", p))
    try:
        assert svc3.standing.get(sid) is None
    finally:
        svc3.close()


def test_chip_smoke_phase16_rehearsal(monkeypatch, tmp_path):
    """chip_smoke.py's phase 16 on the CPU at 8,000 lineitems (the card's
    synchronize stubbed) with every plain kernel version bumping its
    launch counter: every cell passes its checks, all five kernels
    launch, every captured call is held."""
    import types

    import chip_smoke
    from dryad_tpu_torch import JobConfig
    from dryad_tpu_torch.apps import wordcount as wc
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
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "INC_SMALL", 1_500)
    monkeypatch.setattr(chip_smoke, "REMOTE_CHUNK", 512)
    monkeypatch.setattr(chip_smoke, "S3_PART_BYTES", 4_096)
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: TContext(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    lines = chip_smoke.bench_corpus(400)
    want = collections.Counter(w.encode() for ln in lines
                               for w in ln.lower().split())
    out = chip_smoke.phase16_runs(port, hk, wc, 8_000, str(tmp_path),
                                  lines, dict(want), held, device="cpu")
    assert sorted(out) == ["inc_modes", "inc_okey_6m", "inc_q1_6m",
                           "remote_hdfs_6m", "remote_http_text",
                           "remote_s3_6m"]
    for label in ("inc_q1_6m", "inc_okey_6m"):
        assert len(out[label]["rounds"]) == chip_smoke.INC_ROUNDS
    assert out["remote_s3_6m"]["multipart_uploads"] > 0
    assert out["inc_modes"]["rounds"][1]["crashed_first"]
    launched = {k: sum(r[0][k] for r in runs.values())
                for k in chip_smoke.TPU_KERNEL}
    assert all(launched.values()), launched
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
