"""The port's job service on the in-process fleet
(``dryad_tpu_torch/service``) against the JAX package's, on the CPU
(mirrors ``tests/test_service.py``; the cluster fleet is held in
``tests/test_torch_cluster_service.py``).

* the FileCache: round trip, a torn entry read as a miss, entries that
  either package wrote read by the other;
* the admission queue: the pick order and the tenant ledgers of both
  packages after the same scripted submissions and charges;
* the typed rejections: the same codes, zero work started;
* the apps: ``make_tasks`` equal, ``wordcount`` and ``groupsum`` results
  through the port's daemon equal to the JAX daemon's and to oracles;
* SQL submissions: rows against the JAX ``sql.query`` of the same
  catalog (integer columns exactly, f32 sums within 16 eps sum |v| of
  the float64 sums), DTA501 on equivalent queries, one scan per table,
  a cache hit planning the stages of a miss, the version salt;
* concurrency: per-job logs, the dashboard; the HTTP routes and the CLI;
  the daemon without CUDA refused, and a cluster Context's terminal
  handed to its cluster as one gang job;
* a CPU rehearsal of ``chip_smoke.py``'s phase 17.
"""

import json
import os
import threading
import time
import types
from collections import Counter, deque

import numpy as np
import pytest
import torch

from dryad_tpu import sql as jsql
from dryad_tpu.api.dataset import Context as JContext
from dryad_tpu.service import APPS as JAPPS
from dryad_tpu.service import AdmissionQueue as JAdmissionQueue
from dryad_tpu.service import JobService as JJobService
from dryad_tpu.service import ServiceConfig as JServiceConfig
from dryad_tpu.service import TenantQuota as JTenantQuota
from dryad_tpu.service import tenancy as jtenancy
from dryad_tpu.service.apps import task_capacity as jtask_capacity
from dryad_tpu.utils.compile_cache import FileCache as JFileCache
from dryad_tpu_torch import sql
from dryad_tpu_torch.service import (APPS, AdmissionQueue, JobService,
                                     MalformedJobError, QueueFullError,
                                     ServiceConfig, ServiceRejected,
                                     ServiceStoppedError, TenantQuota,
                                     UnknownAppError, tenancy)
from dryad_tpu_torch.service.apps import task_capacity
from dryad_tpu_torch.utils.compile_cache import FileCache
from tests.torch_threads import one_torch_thread  # noqa: F401

EPS = 2.0**-24


def _svc(tmp_path, name="svc", **kw):
    catalog = kw.pop("catalog", None)
    return JobService(ServiceConfig(service_dir=str(tmp_path / name),
                                    journal_fsync=False, **kw),
                      device="cpu", catalog=catalog)


def _wc_oracle(params):
    c = Counter()
    for t in APPS["wordcount"].make_tasks(dict(params), 4):
        for line in t["line"]:
            c.update(line.split())
    return dict(sorted(c.items()))


def _gs_oracle(params):
    sums, cnt = Counter(), Counter()
    for t in APPS["groupsum"].make_tasks(dict(params), 4):
        for k, v in zip(t["k"], t["v"]):
            sums[int(k)] += int(v)
            cnt[int(k)] += 1
    return {str(k): {"sum": sums[k], "count": cnt[k]} for k in sorted(sums)}


# -- FileCache ---------------------------------------------------------------


def test_filecache_roundtrip_torn_entry_and_miss(tmp_path):
    fc = FileCache(str(tmp_path / "fc"))
    assert fc.get("k") is None
    fc.put("k", b"plan bytes")
    assert fc.get("k") == b"plan bytes"
    p = fc._path("k")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 3)       # a torn write
    assert fc.get("k") is None and not os.path.exists(p)
    fc.put("k", b"again")
    assert fc.get("k") == b"again"


@pytest.mark.parametrize("writer,reader", [(JFileCache, FileCache),
                                           (FileCache, JFileCache)])
def test_filecache_entries_cross_between_packages(tmp_path, writer,
                                                  reader):
    d = str(tmp_path / "fc")
    writer(d).put("key", b"\x00payload\xff")
    assert reader(d).get("key") == b"\x00payload\xff"
    assert reader(d).get("other") is None


# -- admission: the same script in both packages ------------------------------


class _FakeJob:
    def __init__(self, tenant, seq, n_tasks, priority=0):
        self.tenant, self.seq, self.priority = tenant, seq, priority
        self.state = "queued"
        self.pending = deque(range(n_tasks))


def _scripted(qcls, quota_cls, scenario):
    """Run one admission scenario; returns the dispatch order as (tenant,
    seq, task) and the final shares."""
    quotas = {"a": quota_cls(share=3.0), "b": quota_cls(share=1.0),
              "c": quota_cls(worker_slots=1, max_concurrent_jobs=1),
              "d": quota_cls(max_concurrent_jobs=10)}
    q = qcls(lambda t: quotas[t])
    order, inflight = [], deque()

    def drain(slots, steps, wall=lambda j: 1.0, fail=lambda j: False):
        for _ in range(steps):
            while len(inflight) < slots:
                u = q.next_unit()
                if u is None:
                    break
                inflight.append(u)
                order.append((u[0].tenant, u[0].seq, u[1]))
            if not inflight:
                return
            job, idx = inflight.popleft()
            q.on_done(job, idx, wall(job), ok=not fail(job))

    if scenario == "shares":
        q.submit(_FakeJob("a", 1, 120))
        q.submit(_FakeJob("b", 2, 120))
        drain(2, 80)
    elif scenario == "wall":
        q.submit(_FakeJob("a", 1, 60))
        q.submit(_FakeJob("b", 2, 60))
        drain(2, 60, wall=lambda j: 4.0 if j.tenant == "a" else 1.0)
    elif scenario == "idle":
        q.submit(_FakeJob("a", 1, 100))
        drain(1, 30)
        q.submit(_FakeJob("b", 2, 100))
        drain(1, 30)
    elif scenario == "priority":
        q.submit(_FakeJob("d", 1, 2, priority=0))
        q.submit(_FakeJob("d", 2, 2, priority=5))
        drain(1, 10)
    elif scenario == "caps":
        jobs = [_FakeJob("c", 1, 3), _FakeJob("c", 2, 3),
                _FakeJob("a", 3, 4)]
        for j in jobs:
            q.submit(j)
        drain(3, 3)
        q.retire(jobs[0])
        drain(3, 20)
    elif scenario == "requeue_restore":
        j = _FakeJob("a", 1, 3)
        q.submit(j)
        job, idx = q.next_unit()
        q.requeue(job, idx)
        q.restore_tenant("b", used_slot_s=5.0, failures=2)
        q.restore_tenant("b", used_slot_s=1.0, failures=1)
        q.submit(_FakeJob("b", 2, 3))
        drain(1, 10, fail=lambda j: j.tenant == "b")
    return order, q.shares(), q.depths()


@pytest.mark.parametrize("scenario", ["shares", "wall", "idle", "priority",
                                      "caps", "requeue_restore"])
def test_admission_order_and_ledgers_match_jax(scenario):
    got = _scripted(AdmissionQueue, TenantQuota, scenario)
    want = _scripted(JAdmissionQueue, JTenantQuota, scenario)
    assert got == want
    assert got[0], "nothing dispatched"


def test_precheck_and_submit_raise_the_same_walls():
    for qcls, qt in ((AdmissionQueue, TenantQuota),
                     (JAdmissionQueue, JTenantQuota)):
        q = qcls(lambda t: qt(max_queued_jobs=1, failure_budget=1))
        q.precheck("fresh")                 # an unseen tenant: nothing
        q.submit(_FakeJob("t", 1, 1))
        with pytest.raises(Exception) as ei:
            q.precheck("t")
        assert ei.value.code == "DTA911"
        job, idx = q.next_unit()
        q.on_done(job, idx, 1.0, ok=False)
        q.on_done(job, idx, 1.0, ok=False)
        with pytest.raises(Exception) as ei:
            q.submit(_FakeJob("t", 2, 1))
        assert ei.value.code == "DTA912"
        q.submit(_FakeJob("t", 3, 1), force=True)   # recovery re-admits


# -- typed rejections --------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("UnknownAppError", ("x", ["wordcount"])),
    ("MalformedJobError", ("x", ValueError("bad"))),
    ("QueueFullError", ("t", 3, 3)), ("FailureBudgetError", ("t", 5, 4)),
    ("ServiceStoppedError", ())])
def test_rejection_codes_and_messages_match_jax(name, args):
    got = getattr(tenancy, name)(*args)
    want = getattr(jtenancy, name)(*args)
    assert got.code == want.code and str(got) == str(want)
    assert isinstance(got, ServiceRejected)


@pytest.mark.parametrize("kw", [{}, {"share": 0}, {"max_queued_jobs": 0},
                                {"slo_target": 1.0}, {"slo_window": 0},
                                {"worker_slots": -1}])
def test_tenant_quota_validation_matches_jax(kw):
    try:
        JTenantQuota(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            TenantQuota(**kw)
        return
    assert TenantQuota(**kw) == TenantQuota(**kw)


def test_typed_rejections_and_zero_work(tmp_path):
    gate = threading.Event()
    svc = _svc(tmp_path, slots=1, tenants={
        "tiny": TenantQuota(max_queued_jobs=1, max_concurrent_jobs=1),
        "flaky": TenantQuota(failure_budget=1)})
    try:
        with pytest.raises(UnknownAppError) as ei:
            svc.submit("no-such-app", tenant="tiny")
        assert ei.value.code == "DTA910"
        blocked = svc.submit_callable(lambda env: gate.wait(30),
                                      tenant="tiny")
        t0 = time.time()
        while svc.status(blocked)["state"] != "running":
            assert time.time() - t0 < 30
            time.sleep(0.01)
        queued = svc.submit_callable(lambda env: None, tenant="tiny")
        with pytest.raises(QueueFullError) as ei:
            svc.submit_callable(lambda env: None, tenant="tiny")
        assert ei.value.code == "DTA911" and ei.value.tenant == "tiny"
        assert set(os.listdir(svc.jobs_dir)) == {blocked, queued}
        assert svc.log.of_type("job_rejected")[-1]["code"] == "DTA911"
        gate.set()
        assert svc.wait(blocked, timeout=30)["state"] == "done"
        assert svc.wait(queued, timeout=30)["state"] == "done"
        for _ in range(2):
            jid = svc.submit_callable(
                lambda env: (_ for _ in ()).throw(ValueError("boom")),
                tenant="flaky")
            assert svc.wait(jid, timeout=30)["state"] == "failed"
        with pytest.raises(ServiceRejected) as ei:
            svc.submit_callable(lambda env: None, tenant="flaky")
        assert ei.value.code == "DTA912"
        svc.admission.reset_failures("flaky")
        ok = svc.submit_callable(lambda env: 1, tenant="flaky")
        assert svc.wait(ok, timeout=30)["state"] == "done"
        for bad in ("../../../tmp/evil", "a/b", "..", ".hidden", "",
                    "x" * 80):
            with pytest.raises(MalformedJobError):
                svc.submit("wordcount", {"n_lines": 8}, tenant=bad)
        with pytest.raises(MalformedJobError) as ei:
            svc.submit("wordcount", {"n_lines": "lots"}, tenant="t")
        assert ei.value.code == "DTA910"
    finally:
        gate.set()
        svc.close()
    with pytest.raises(ServiceStoppedError) as ei:
        svc.submit("wordcount")
    assert ei.value.code == "DTA913"


def test_submission_runs_the_lint_gate(tmp_path):
    from dryad_tpu_torch import JobConfig
    from dryad_tpu_torch.analysis.diagnostics import LintError
    svc = _svc(tmp_path, slots=1, job_config=JobConfig(
        lint="error", device_hbm_bytes=2048))
    try:
        with pytest.raises(LintError) as ei:
            svc.submit("groupsum", {"n_rows": 200_000}, tenant="t")
        assert ei.value.report.by_code("DTA201")
        assert svc.list_jobs() == []
        assert svc.admission.shares().get("t", (0, 0, 0))[2] == 0
    finally:
        svc.close()


def test_no_cuda_refuses_and_the_cluster_waits_for_item_11(tmp_path,
                                                           monkeypatch):
    """``JobService()`` runs on the card: without CUDA it raises before
    creating anything, and so does a ``LocalCluster`` on the card before
    spawning a worker.  ``submit_tasks`` needs the cluster fleet; a
    cluster Context's terminal, without a device on the driver, is ONE
    gang job handed to the cluster's ``execute`` (the gang half of
    ROADMAP item 11 is in) with the plan and the deferred source."""
    from dryad_tpu_torch import Context
    from dryad_tpu_torch.runtime import LocalCluster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tmp_path / "svc"
    with pytest.raises(RuntimeError, match="CUDA"):
        JobService(ServiceConfig(service_dir=str(d)))
    assert not d.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalCluster(n_processes=1, log_dir=str(tmp_path / "logs"))
    assert not (tmp_path / "logs" / "worker-0.log").exists()
    sent = []

    def execute(plan_json, specs, **kw):
        sent.append((plan_json, specs, kw))
        return {"table": {"k": np.arange(10, dtype=np.int32)}}
    fake = types.SimpleNamespace(n_processes=2, devices_per_process=4,
                                 execute=execute, event_log=None)
    ds = Context(cluster=fake).from_columns(
        {"k": np.arange(10, dtype=np.int32)})
    assert ds.ctx.nparts == 8 and ds.ctx.device is None
    np.testing.assert_array_equal(ds.collect()["k"], np.arange(10))
    ((plan_json, specs, kw),) = sent
    assert kw["collect"] is True and '"stages"' in plan_json
    assert [s["kind"] for s in specs.values()] == ["columns"]
    svc = _svc(tmp_path, slots=1)
    try:
        with pytest.raises(ValueError, match="cluster fleet"):
            svc.submit_tasks("{}", [{}])
    finally:
        svc.close()


def test_close_releases_inflight_waiters(tmp_path):
    gate = threading.Event()
    svc = _svc(tmp_path, slots=1)
    jid = svc.submit_callable(lambda env: gate.wait(30), tenant="t")
    t0 = time.time()
    while svc.status(jid)["state"] != "running":
        assert time.time() - t0 < 30
        time.sleep(0.01)
    row = {}
    waiter = threading.Thread(target=lambda: row.update(svc.wait(jid)),
                              daemon=True)
    waiter.start()
    closer = threading.Thread(target=svc.close, daemon=True)
    closer.start()
    closer.join(timeout=60)
    waiter.join(timeout=30)
    assert not closer.is_alive() and not waiter.is_alive()
    assert row["state"] == "failed" and "service stopped" in row["error"]
    gate.set()


def test_terminal_job_retention_prunes_the_registry(tmp_path):
    from dryad_tpu_torch.obs.metrics import REGISTRY
    svc = _svc(tmp_path, slots=1, max_terminal_jobs=1)
    try:
        jids = []
        for _ in range(3):
            jid = svc.submit_callable(lambda env: 1, tenant="t")
            assert svc.wait(jid, timeout=60)["state"] == "done"
            jids.append(jid)
        with pytest.raises(KeyError):
            svc.status(jids[0])
        assert svc.status(jids[1])["state"] == "done"
        assert not any(f'job="{jids[0]}"' in k for k in REGISTRY.snapshot())
        assert os.path.isdir(os.path.join(svc.jobs_dir, jids[0]))
    finally:
        svc.close()


# -- apps --------------------------------------------------------------------


@pytest.mark.parametrize("app,params", [
    ("wordcount", {"n_lines": 50, "seed": 3, "n_tasks": 3}),
    ("wordcount", {"n_lines": 3000, "seed": 0}),
    ("wordcount", {"n_lines": 400, "seed": 2**40 + 5,
                   "words_per_line": 9}),
    ("wordcount", {"n_lines": 7, "seed": -4, "words_per_line": 1}),
    ("wordcount", {"n_lines": 0}),
    ("wordcount", {"lines": ["a b", "c"], "n_tasks": 5}),
    ("groupsum", {"n_rows": 300, "n_keys": 5, "seed": 1})])
def test_app_tasks_and_capacity_match_jax(app, params):
    """The tasks equal the JAX app's, the wordcount lines included (the
    port draws ``random.Random(seed).choice``'s sequence in bulk)."""
    got = APPS[app].make_tasks(dict(params), 8)
    want = JAPPS[app].make_tasks(dict(params), 8)
    assert got == want
    assert task_capacity(got, 8) == jtask_capacity(want, 8)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8, 10, 15, 16, 17, 100, 1000,
                               2**31 + 3])
def test_bulk_choices_equal_random_choice(k):
    """The bulk draw equals ``random.Random(seed).choice(range(k))`` for a
    vocabulary of any size, not only the 10 words of today's app."""
    import random
    from dryad_tpu_torch.service.apps import _choices
    rng = random.Random(11)
    want = [rng.choice(range(k)) for _ in range(500)]
    assert _choices(11, 500, k).tolist() == want


def test_app_results_match_the_jax_daemon_and_oracles(tmp_path):
    """Two tenants' wordcount and groupsum jobs on two slots of each
    package's daemon: equal results, equal to the host oracles, each
    job's JSONL tagged with its own id, the dashboard listing them."""
    jobs = [("wordcount", {"n_lines": 96, "n_tasks": 2, "seed": 1},
             "alice"), ("groupsum", {"n_rows": 512, "n_keys": 8,
                                     "seed": 2}, "bob"),
            ("wordcount", {"n_lines": 48, "seed": 3}, "bob")]
    results = {}
    for name, svc in (
            ("port", _svc(tmp_path, "port", slots=2)),
            ("jax", JJobService(JServiceConfig(
                service_dir=str(tmp_path / "jax"), slots=2,
                journal_fsync=False)))):
        try:
            jids = [svc.submit(a, p, tenant=t) for a, p, t in jobs]
            rows = [svc.wait(j, timeout=300) for j in jids]
            assert all(r["state"] == "done" for r in rows), rows
            results[name] = [r["result"] for r in rows]
            if name == "port":
                for j in jids:
                    with open(os.path.join(svc.jobs_dir, j,
                                           "events.jsonl")) as f:
                        ev = [json.loads(x) for x in f]
                    assert ev and all(e.get("job") == j for e in ev)
                html = svc.dashboard_html()
                assert all(j in html for j in jids)
                assert svc.cancel(jids[0]) is False
        finally:
            svc.close()
    assert results["port"] == results["jax"]
    assert results["port"][0]["words"] == _wc_oracle(jobs[0][1])
    assert results["port"][1]["groups"] == _gs_oracle(jobs[1][1])


# -- SQL submissions ---------------------------------------------------------

Q1 = ("SELECT qty, COUNT(*) AS n, SUM(price) AS s, AVG(price) AS a, "
      "MIN(price) AS lo, MAX(price) AS hi FROM lineitem "
      "WHERE tag != 'void' GROUP BY qty ORDER BY qty")
Q3 = ("SELECT l.okey, SUM(l.price * l.qty) AS revenue, COUNT(*) AS n "
      "FROM lineitem l JOIN orders o ON l.okey = o.okey "
      "WHERE o.flag = 0 GROUP BY l.okey ORDER BY revenue DESC LIMIT 10")
Q1_ALT = ("SELECT MAX(t.price) AS hi, t.qty, AVG(t.price) AS a, "
          "COUNT(*) AS n, MIN(t.price) AS lo, SUM(t.price) AS s "
          "FROM lineitem t WHERE 'void' != t.tag GROUP BY t.qty "
          "ORDER BY qty")
Q3_ALT = ("SELECT COUNT(*) AS n, x.okey, SUM(x.qty * x.price) AS revenue "
          "FROM lineitem x JOIN orders y ON y.okey = x.okey "
          "WHERE y.flag = 0 GROUP BY x.okey ORDER BY revenue DESC "
          "LIMIT 10")


def _tables(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    li = {"okey": rng.randint(0, 200, n).astype(np.int32),
          "price": rng.randint(1, 100, n).astype(np.float32),
          "qty": rng.randint(1, 10, n).astype(np.int32),
          "tag": ([b"void", b"ok", b"ok"] * (n // 3 + 1))[:n]}
    orders = {"okey": np.arange(200, dtype=np.int32),
              "flag": (np.arange(200) % 2).astype(np.int32)}
    return li, orders


def _catalog(mod, li, orders):
    cat = mod.Catalog()
    cat.register_columns("lineitem", li)
    cat.register_columns("orders", orders)
    return cat


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX package's ``sql.query`` of Q1 and Q3 on the same tables."""
    li, orders = _tables()
    cat = _catalog(jsql, li, orders)
    return {name: jsql.query(JContext(), cat, text).collect()
            for name, text in (("q1", Q1), ("q3", Q3))}


def _same_rows(got: dict, want: dict, f32=()):
    """Equal row multisets: the ``f32`` columns (sums of f32) within 16
    eps x |value| x 2 (each side within 16 eps sum |v| of the exact sum;
    the prices are positive), the others exactly."""
    cols = sorted(want)
    assert sorted(got) == cols
    g = sorted(zip(*[np.asarray(got[c]).tolist() for c in cols]))
    w = sorted(zip(*[np.asarray(want[c]).tolist() for c in cols]))
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for c, x, y in zip(cols, rg, rw):
            if c in f32:
                assert abs(x - y) <= 32 * EPS * abs(y), (c, x, y)
            else:
                assert x == y, (c, x, y)


def test_sql_rows_reuse_and_shared_scans(tmp_path, jax_rows):
    """Two tenants submit Q1, Q3 and an equivalent form of each: every
    result equals the JAX package's rows; the two first forms miss the
    plan cache and the two equivalent ones hit it (DTA501 events, the
    ``plan_reuse`` counter); ONE scan span per table and ``scan_shared``
    for every other use; a hit's graph has the stages of the miss."""
    li, orders = _tables()
    svc = _svc(tmp_path, slots=2, catalog=_catalog(sql, li, orders))
    try:
        q1_before = svc.explain_sql(Q1_ALT)
        assert "no cached equivalent" in q1_before
        subs = [(Q1, "q1", "a"), (Q3, "q3", "b"), (Q1_ALT, "q1", "b"),
                (Q3_ALT, "q3", "a")]
        jids = [(svc.submit_sql(q, tenant=t), k) for q, k, t in subs]
        assert "DTA501" in svc.explain_sql(Q1_ALT)
        for jid, kind in jids:
            row = svc.wait(jid, timeout=300)
            assert row["state"] == "done", row.get("error")
            _same_rows(row["result"]["table"], jax_rows[kind],
                       f32=("s", "a", "revenue"))
        reuse = svc.log.of_type("reuse_verdict")
        assert [r["job"] for r in reuse] == [jids[2][0], jids[3][0]]
        assert all(r["code"] == "DTA501" for r in reuse)
        spans = sorted(e["name"] for e in svc.log.of_type("span")
                       if e.get("kind") == "io")
        assert spans == ["scan lineitem", "scan orders"]
        shared = Counter(e["table"] for e in svc.log.of_type("scan_shared"))
        assert shared == {"lineitem": 3, "orders": 1}
        for jid, _ in jids:
            ev = svc.jobs[jid].log.events
            assert all(e.get("job") == jid for e in ev)
        # a hit rebuilt the miss's stage graph: the same stage labels
        plans = {jid: next(e["plan"] for e in svc.jobs[jid].log.events
                           if e["event"] == "plan") for jid, _ in jids}
        for miss, hit in ((0, 2), (1, 3)):
            labels = [[s["label"] for s in json.loads(plans[j])["stages"]]
                      for j in (jids[miss][0], jids[hit][0])]
            assert labels[0] == labels[1]
        assert 'dryad_semantic_plan_reuse_total{tenant="b"}' in \
            svc.metrics_text()
    finally:
        svc.close()


def test_plan_cache_key_salts_the_code_version(tmp_path):
    """The cache key carries ``dryad_tpu_torch.__version__``, the release
    plus a digest of the package's sources: an entry cached under another
    version is a miss, never served."""
    import dryad_tpu_torch
    assert dryad_tpu_torch.__version__.startswith(dryad_tpu_torch._RELEASE)
    assert len(dryad_tpu_torch.__version__.split("+")[1]) == 12
    li, orders = _tables(300)
    svc = _svc(tmp_path, slots=1, catalog=_catalog(sql, li, orders))
    try:
        key = json.loads(svc._sql_cache_key("f", "c"))
        assert key["ver"] == dryad_tpu_torch.__version__
        assert svc.wait(svc.submit_sql(Q1), timeout=120)["state"] == "done"
        assert "DTA501" in svc.explain_sql(Q1)
        real = dryad_tpu_torch.__version__
        try:
            dryad_tpu_torch.__version__ = real + "-other"
            assert "no cached equivalent" in svc.explain_sql(Q1)
        finally:
            dryad_tpu_torch.__version__ = real
    finally:
        svc.close()


def test_resolve_fn_table_resolves_only_the_port(tmp_path):
    """A cached plan's refs resolve into ``dryad_tpu_torch`` only: a ref
    into any other module, the JAX package's among them, is DTA905."""
    from dryad_tpu_torch.runtime.shiplan import (PlanShipError,
                                                 _collect_refs,
                                                 resolve_fn_table)
    from dryad_tpu_torch.service import apps
    plan = json.dumps({"stages": [{"legs": [{"ops": [{"params": {
        "f": {"__fn__": "dryad_tpu_torch.service.apps:get_app"}}}]}],
        "body": []}]})
    assert resolve_fn_table(plan) == {
        "dryad_tpu_torch.service.apps:get_app": apps.get_app}
    for ref in ("dryad_tpu.service.apps:get_app", "os:getcwd", "noname"):
        bad = plan.replace("dryad_tpu_torch.service.apps:get_app", ref)
        with pytest.raises(PlanShipError) as ei:
            resolve_fn_table(bad)
        assert ei.value.code == "DTA905"
    from dryad_tpu_torch import Context
    tctx = Context(device="cpu", nparts=8)
    ds = tctx.from_columns({"k": np.arange(10, dtype=np.int32)}).select(
        lambda c: c)
    from dryad_tpu_torch.plan.planner import plan_query
    with pytest.raises(PlanShipError) as ei:
        _collect_refs(plan_query(ds.node, 8), {})
    assert ei.value.code == "DTA014"


# -- HTTP front end and CLI --------------------------------------------------


@pytest.fixture()
def http_service(tmp_path):
    from dryad_tpu_torch.service.http import serve
    li, orders = _tables(600)
    svc = _svc(tmp_path, slots=2, catalog=_catalog(sql, li, orders),
               tenants={"tiny": TenantQuota(max_queued_jobs=1)})
    srv, port = serve(svc)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield svc, f"http://127.0.0.1:{port}"
    finally:
        srv.shutdown()
        svc.close()


def test_http_routes(http_service):
    import urllib.error
    import urllib.request

    from dryad_tpu_torch.service.http import Client
    svc, url = http_service
    c = Client(url)
    params = {"n_lines": 48, "seed": 7}
    jid = c.submit("wordcount", params, tenant="alice")
    row = c.wait(jid, timeout=300)
    assert row["state"] == "done"
    assert row["result"]["words"] == _wc_oracle(params)
    assert [r["job"] for r in c.jobs()] == [jid]
    assert "alice" in c.tenants() and c.slo() == {}
    assert c.latency()["alice"]["count"] == 1
    q = c.submit_sql(Q1, tenant="bob")
    frames = list(c.stream_events(q))
    assert "job_submitted" in [e["event"] for e in frames]
    assert frames[-1]["event"] == "job_archived"
    assert all(e["job"] == q for e in frames)
    assert c.wait(q)["state"] == "done"
    q2 = c.submit_sql(Q1_ALT, tenant="bob")
    assert c.wait(q2)["state"] == "done"
    polled = c.events(q2, after=0, timeout_s=1)
    assert any(e["event"] == "reuse_verdict" for e in polled["events"])
    metrics = c.metrics()
    assert "dryad_semantic_plan_reuse_total" in metrics
    assert "dryad_scan_shares_total" in metrics
    assert f'job="{jid}"' in metrics
    for bad, code in ((lambda: c.submit("no-such-app"), "DTA910"),
                      (lambda: c.submit("wordcount", {"n_lines": "x"}),
                       "DTA910"),
                      (lambda: c.submit_sql("SELEC nope"), "DTA301")):
        with pytest.raises(ServiceRejected) as ei:
            bad()
        assert ei.value.code == code
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/status/nope")
    assert ei.value.code == 404
    html = urllib.request.urlopen(url + "/").read().decode()
    assert jid in html and "<h2>tenants</h2>" in html
    assert c.cancel(jid) is False


def test_cli_submit_status_list(http_service, capsys):
    from dryad_tpu_torch.service.__main__ import main
    svc, url = http_service
    rc = main(["submit", "--url", url, "wordcount", "--params",
               '{"n_lines": 32, "seed": 9}', "--tenant", "cli", "--wait",
               "--timeout", "300"])
    row = json.loads(capsys.readouterr().out)
    assert rc == 0 and row["state"] == "done"
    assert row["result"]["words"] == _wc_oracle({"n_lines": 32, "seed": 9})
    assert main(["status", "--url", url, row["job"]]) == 0
    assert json.loads(capsys.readouterr().out)["state"] == "done"
    assert main(["list", "--url", url]) == 0
    assert row["job"] in capsys.readouterr().out
    assert main(["submit", "--url", url, "--sql", Q1, "--wait"]) == 0
    assert json.loads(capsys.readouterr().out)["result"]["rows"] == 9
    assert main(["submit", "--url", url, "no-such-app"]) == 2
    assert "DTA910" in capsys.readouterr().err
    assert main(["submit", "--url", url, "wordcount", "--params",
                 "{not json"]) == 3


# -- chip_smoke.py's phase 17 on the CPU --------------------------------------


def test_chip_smoke_phase17_rehearsal(monkeypatch, tmp_path):
    """Phase 17 at 6,000 lineitems and 2,000 wordcount lines, the card's
    synchronize stubbed and every plain kernel version bumping its
    launch counter: every cell passes its checks, all five kernels
    launch, every captured call is held."""
    import chip_smoke
    from dryad_tpu_torch import Context, JobConfig
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
    monkeypatch.setattr(chip_smoke, "SVC_WC_LINES", 2_000)
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: Context(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    tables = chip_smoke.sql_catalog(sql, 6_000)
    out = chip_smoke.phase17_runs(port, hk, tables, 6_000, str(tmp_path),
                                  held, 1.0, device="cpu")
    assert sorted(out) == ["svc_durable_6m", "svc_http", "svc_sql_6m",
                           "svc_standing_6m", "svc_wordcount"]
    assert out["svc_sql_6m"]["dta501"] == 10
    wc = out["svc_wordcount"]
    assert 0 < wc["submit_s"] <= wc["fleet_s"]
    assert {"bind", "run"} <= set(wc["fleet_phase_s"]), wc
    assert out["svc_durable_6m"]["crash"]["charges"] == {"dash": 2,
                                                         "adhoc": 2}
    assert len(out["svc_standing_6m"]["rounds"]) == \
        chip_smoke.INC_ROUNDS + 1
    launched = {k: sum(r[0][k] for r in runs.values())
                for k in chip_smoke.TPU_KERNEL}
    assert all(launched.values()), launched
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
    assert sorted(runs) == sorted(out)
