"""The job service's cluster fleet in the port
(``JobService(cluster=LocalCluster(...))``, ``service/daemon.py``'s
``_ClusterFleet``) on the CPU, over one module-scoped
``LocalCluster(2, 2, device="cpu")``:

* ``wordcount`` and ``groupsum`` results equal the port's in-process
  fleet's, the JAX package's in-process service's and the host oracles;
  each job's events are its own, each ``task_done`` carries the task's
  kernel ``launches``;
* ``submit_sql`` over a catalog whose lineitem is a STORE (each task's
  worker reads it) equals the JAX ``sql.query`` rows, as the port's and
  the JAX package's in-process services do; the second equivalent
  submission is DTA501, its plan and deferred sources from the pickled
  FileCache entry;
* ``submit_tasks`` runs a serialized plan with per-task sources;
* what needs the in-process fleet (standing queries,
  ``submit_callable``) is refused; a failing task fails only its job,
  with a forensics bundle under the job's directory;
* a queued cluster job survives a crashed daemon: the successor
  re-admits it from the journal and it finishes with the same result.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_cluster_fns as F  # noqa: E402

from dryad_tpu import sql as jsql  # noqa: E402
from dryad_tpu.api.dataset import Context as JContext  # noqa: E402
from dryad_tpu.service import JobService as JJobService  # noqa: E402
from dryad_tpu.service import ServiceConfig as JServiceConfig  # noqa: E402
from dryad_tpu_torch import Context, sql  # noqa: E402
from dryad_tpu_torch.plan.planner import plan_query  # noqa: E402
from dryad_tpu_torch.runtime import LocalCluster  # noqa: E402
from dryad_tpu_torch.runtime.shiplan import \
    serialize_for_cluster  # noqa: E402
from dryad_tpu_torch.runtime.sources import columns_spec  # noqa: E402
from dryad_tpu_torch.service import (JobService,  # noqa: E402
                                     MalformedJobError, ServiceConfig)
from tests.test_torch_service import (Q1, Q1_ALT, Q3, Q3_ALT,  # noqa: E402
                                      _gs_oracle, _same_rows, _tables,
                                      _wc_oracle)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

JOBS = [("wordcount", {"n_lines": 96, "n_tasks": 3, "seed": 1}, "alice"),
        ("groupsum", {"n_rows": 512, "n_keys": 8, "seed": 2}, "bob"),
        ("wordcount", {"n_lines": 48, "seed": 3}, "bob")]


@pytest.fixture(scope="module")
def cluster():
    old = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["PYTHONPATH"] = HERE + os.pathsep + (old["PYTHONPATH"] or "")
    os.environ["OMP_NUM_THREADS"] = "1"
    cl = LocalCluster(n_processes=2, devices_per_process=2,
                      fn_modules=("torch_cluster_fns",), device="cpu")
    yield cl
    cl.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _svc(tmp_path, cluster, name="svc", **kw):
    catalog = kw.pop("catalog", None)
    return JobService(ServiceConfig(service_dir=str(tmp_path / name),
                                    journal_fsync=False, **kw),
                      cluster=cluster, catalog=catalog)


def _results(svc):
    jids = [svc.submit(a, p, tenant=t) for a, p, t in JOBS]
    rows = [svc.wait(j, timeout=300) for j in jids]
    assert all(r["state"] == "done" for r in rows), rows
    return jids, [r["result"] for r in rows]


def test_app_results_equal_both_in_process_services(tmp_path, cluster):
    svc = _svc(tmp_path, cluster, "cl")
    try:
        assert svc.slots == 2 and svc.standing is None
        jids, got = _results(svc)
        for j, (app, params, _t) in zip(jids, JOBS):
            with open(os.path.join(svc.jobs_dir, j, "events.jsonl")) as f:
                ev = [json.loads(x) for x in f]
            assert ev and all(e.get("job") == j for e in ev)
            done = [e for e in ev if e["event"] == "task_done"]
            assert len(done) == svc.job(j).n_tasks
            assert all(set(e["launches"]) == {
                "hist_buckets", "prefix_sum", "prefix_sum2", "slot_expand",
                "slot_compact", "hash_keys", "seg_scan"} for e in done)
            # one job_done (the service's), none from the workers' tasks
            assert [e["event"] for e in ev].count("job_done") == 1
    finally:
        svc.close()
    local = JobService(ServiceConfig(service_dir=str(tmp_path / "local"),
                                     journal_fsync=False), device="cpu")
    try:
        assert _results(local)[1] == got
    finally:
        local.close()
    jax = JJobService(JServiceConfig(service_dir=str(tmp_path / "jax"),
                                     journal_fsync=False))
    try:
        assert _results(jax)[1] == got
    finally:
        jax.close()
    assert got[0]["words"] == _wc_oracle(JOBS[0][1])
    assert got[1]["groups"] == _gs_oracle(JOBS[1][1])


def test_sql_over_a_store_equals_jax_and_reuses_the_plan(tmp_path,
                                                         cluster):
    li, orders = _tables()
    store = str(tmp_path / "lineitem")
    Context(device="cpu", nparts=4).from_columns(li).to_store(store)
    cat = sql.Catalog().register_store("lineitem", store) \
        .register_columns("orders", orders)
    jcat = jsql.Catalog()
    jcat.register_columns("lineitem", li)
    jcat.register_columns("orders", orders)
    want = {k: jsql.query(JContext(), jcat, q).collect()
            for k, q in (("q1", Q1), ("q3", Q3))}
    # the in-process fleets of both packages answer the same
    for name, other in (
            ("local", JobService(ServiceConfig(
                service_dir=str(tmp_path / "local"), journal_fsync=False),
                device="cpu", catalog=cat)),
            ("jax", JJobService(JServiceConfig(
                service_dir=str(tmp_path / "jax"), journal_fsync=False),
                catalog=jcat))):
        try:
            for k, q in (("q1", Q1), ("q3", Q3)):
                row = other.wait(other.submit_sql(q), timeout=300)
                assert row["state"] == "done", (name, row.get("error"))
                _same_rows(row["result"]["table"], want[k],
                           f32=("s", "a", "revenue"))
        finally:
            other.close()
    svc = _svc(tmp_path, cluster, catalog=cat)
    try:
        subs = [(Q1, "q1"), (Q3, "q3"), (Q1_ALT, "q1"), (Q3_ALT, "q3")]
        jids = [(svc.submit_sql(q, tenant="t"), k) for q, k in subs]
        for jid, kind in jids:
            row = svc.wait(jid, timeout=300)
            assert row["state"] == "done", row.get("error")
            _same_rows(row["result"]["table"], want[kind],
                       f32=("s", "a", "revenue"))
        reuse = svc.log.of_type("reuse_verdict")
        assert [r["job"] for r in reuse] == [jids[2][0], jids[3][0]]
        assert all(r["code"] == "DTA501" for r in reuse)
        # a hit's payload is the cached plan + deferred specs: the
        # lineitem source is a store spec its worker reads
        from dryad_tpu_torch.analysis.canon import semantic_fingerprint
        bound = sql.compile_query(cat, Q1_ALT)[1]
        payload, limit, hit = svc._build_sql_farm_payload(
            bound, semantic_fingerprint(cat, bound), cat.fingerprint())
        assert hit and limit is None and len(payload["sources"]) == 1
        (spec,) = payload["sources"][0].values()
        assert (spec["kind"], spec["path"]) == ("store", store)
    finally:
        svc.close()


def test_submit_tasks_and_in_process_only_surfaces(tmp_path, cluster):
    ctx = Context(cluster=cluster)
    # a cluster Context spans the gang; a farm task is sized to one
    # worker's partitions from the cluster itself
    assert ctx.nparts == cluster.nparts > cluster.devices_per_process
    q = (ctx.from_columns({"v": np.arange(4, dtype=np.int32)})
         .select(F.double_v).where(F.keep_positive))
    plan_json, specs = serialize_for_cluster(
        plan_query(q.node, cluster.devices_per_process))
    (src_key,) = specs
    vals = np.arange(-30, 30, dtype=np.int32)
    per_task = [{src_key: columns_spec({"v": b}, 2)}
                for b in np.array_split(vals, 4)]
    Context(device="cpu", nparts=2).from_columns(
        {"k": np.arange(5, dtype=np.int32)}).to_store(str(tmp_path / "t"))
    cat = sql.Catalog().register_store("t", str(tmp_path / "t"))
    svc = _svc(tmp_path, cluster, catalog=cat)
    try:
        jid = svc.submit_tasks(
            plan_json, per_task, tenant="t",
            combine=lambda ts: sorted(int(x) for t in ts for x in t["v"]))
        row = svc.wait(jid, timeout=300)
        assert row["state"] == "done", row.get("error")
        assert row["result"] == sorted((vals * 2)[vals > 0].tolist())
        assert row["tasks_done"] == 4
        with pytest.raises(ValueError, match="in-process fleet"):
            svc.submit_callable(lambda env: 1)
        with pytest.raises(MalformedJobError, match="in-process fleet"):
            svc.submit_sql("SELECT k FROM t EMIT EVERY 1")
    finally:
        svc.close()


def test_a_failing_task_fails_only_its_job(tmp_path, cluster):
    """A poison task (a wider string column) fails its job with a
    forensics bundle under the job's directory; a job submitted beside
    it finishes."""
    from dryad_tpu_torch.apps.wordcount import wordcount_query
    ctx = Context(cluster=cluster)
    q = wordcount_query(ctx.from_columns({"line": ["a"]})
                        .select(F.poison_wide_lines),
                        tokens_per_partition=64)
    plan_json, specs = serialize_for_cluster(
        plan_query(q.node, cluster.devices_per_process))
    (src_key,) = specs
    svc = _svc(tmp_path, cluster)
    try:
        bad = svc.submit_tasks(plan_json, [
            {src_key: columns_spec({"line": ["a b"]}, 2, str_max_len=64)},
            {src_key: columns_spec({"line": ["c"]}, 2, str_max_len=128)}])
        good = svc.submit("wordcount", {"n_lines": 32, "seed": 5})
        row = svc.wait(bad, timeout=300)
        assert row["state"] == "failed"
        assert "poison partition" in row["error"]
        assert "python -m dryad_tpu_torch.obs replay" in row["error"]
        bdir = os.path.join(svc.jobs_dir, bad, "bundles")
        assert len(os.listdir(bdir)) == 1
        assert svc.wait(good, timeout=300)["state"] == "done"
    finally:
        svc.close()


def test_a_queued_cluster_job_survives_a_crash(tmp_path, cluster):
    svc = _svc(tmp_path, cluster)
    svc._fleet.stop()           # nothing dispatches: the job stays queued
    jid = svc.submit("wordcount", {"n_lines": 40, "seed": 7})
    assert svc.status(jid)["state"] == "queued"
    svc.crash()
    succ = _svc(tmp_path, cluster)
    try:
        assert succ.recovery["readmitted"] == 1
        row = succ.wait(jid, timeout=300)
        assert row["state"] == "done", row.get("error")
        assert row["result"]["words"] == _wc_oracle(
            {"n_lines": 40, "seed": 7})
    finally:
        succ.close()
