"""The port's task farm (``dryad_tpu_torch/runtime/farm.py``) over real
worker processes on the CPU (one module-scoped ``LocalCluster(2, 2,
device="cpu")``), and its shipping helpers against the JAX package's:

* ``columns_spec`` / ``text_spec`` / ``store_spec`` / ``farm_store_tasks``
  / the locality helpers equal JAX's on the same inputs (the store
  helpers over one store written by each package);
* ``serialize_for_cluster`` gives JAX's plan JSON once the package
  prefix is rewritten, and the same specs; a source that is not deferred
  is DTA015 in both;
* the speculation threshold (``TaskFarm._threshold``) equals JAX's;
* farm results equal numpy and the port's in-process run: plain, with a
  ``delay_hook`` straggler (exactly one duplicate, the first finisher
  wins), a SIGKILLed worker (only its in-flight tasks reassigned), an
  elastic joiner, store partitions with writer locality, and ``hdfs://``
  block-host locality through the loopback WebHDFS fake;
* a cluster Context's terminals run as gang jobs with the in-process
  results; an elastic worker refuses a gang job (``run``);
* a farm task's Run emits no ``job_done``; a reply carries its
  ``launches``.
"""

import os
import signal
import sys
import threading
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_cluster_fns as F  # noqa: E402

from dryad_tpu.api.dataset import Context as JContext  # noqa: E402
from dryad_tpu.io.store import store_meta as jstore_meta  # noqa: E402
from dryad_tpu.plan.planner import plan_query as jplan_query  # noqa: E402
from dryad_tpu.runtime import farm as jfarm  # noqa: E402
from dryad_tpu.runtime import shiplan as jshiplan  # noqa: E402
from dryad_tpu.runtime import sources as jsources  # noqa: E402
from dryad_tpu_torch import Context  # noqa: E402
from dryad_tpu_torch.io.store import store_meta  # noqa: E402
from dryad_tpu_torch.plan.planner import plan_query  # noqa: E402
from dryad_tpu_torch.runtime import LocalCluster, protocol  # noqa: E402
from dryad_tpu_torch.runtime import sources  # noqa: E402
from dryad_tpu_torch.runtime.farm import TaskFarm  # noqa: E402
from dryad_tpu_torch.runtime.shiplan import (PlanShipError,  # noqa: E402
                                             serialize_for_cluster)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

DPP = 2          # partitions of each worker's mesh


@pytest.fixture(scope="module")
def cluster():
    old = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["PYTHONPATH"] = HERE + os.pathsep + (old["PYTHONPATH"] or "")
    os.environ["OMP_NUM_THREADS"] = "1"
    cl = LocalCluster(n_processes=2, devices_per_process=DPP,
                      fn_modules=("torch_cluster_fns",), device="cpu")
    yield cl
    cl.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _query(ctx):
    return (ctx.from_columns({"v": np.arange(4, dtype=np.int32)})
            .select(F.double_v).where(F.keep_positive))


def _farm_plan(cluster):
    """One plan (v -> 2v, keep positive) whose single source leg each
    task rebinds."""
    ctx = Context(cluster=cluster)
    graph = plan_query(_query(ctx).node, cluster.devices_per_process)
    plan_json, specs = serialize_for_cluster(graph, ctx.fn_table)
    (src_key,) = specs
    return plan_json, src_key


def _tasks(src_key, n_tasks, n_rows=400, seed=3):
    vals = np.random.default_rng(seed).integers(-50, 50, n_rows) \
        .astype(np.int32)
    return vals, [{src_key: sources.columns_spec({"v": b}, DPP)}
                  for b in np.array_split(vals, n_tasks)]


def _check(vals, results):
    got = np.concatenate([np.asarray(r["v"]) for r in results])
    exp = (vals * 2)[vals * 2 > 0]
    assert sorted(got.tolist()) == sorted(exp.tolist())


def _in_process(blocks):
    """The same query over each task's rows on one in-process Context."""
    ctx = Context(device="cpu", nparts=DPP)
    out = []
    for b in blocks:
        q = (ctx.from_columns({"v": b}).select(F.double_v)
             .where(F.keep_positive))
        out.append(q.collect())
    return out


def _same_spec(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "columns":
            assert set(a[k]) == set(b[k])
            for c in a[k]:
                assert np.array_equal(np.asarray(a[k][c]),
                                      np.asarray(b[k][c]))
        else:
            assert a[k] == b[k], k


# -- the shipping helpers against JAX ----------------------------------------


def test_specs_equal_jax(tmp_path):
    cols = {"v": np.arange(37, dtype=np.int32), "s": ["a", "bb"] * 18
            + ["c"]}
    for kw in ({}, {"capacity": 64}, {"str_max_len": 16}):
        for n in (1, 2, 8):
            _same_spec(sources.columns_spec(cols, n, **kw),
                       jsources.columns_spec(cols, n, **kw))
    paths = []
    for i, body in enumerate((b"a\nbb\n\nccc", b"x\n" * 9, b"")):
        p = tmp_path / f"t{i}.txt"
        p.write_bytes(body)
        paths.append(str(p))
        assert sources.count_lines(body) == jsources.count_lines(body)
        assert sources.count_lines_file(str(p)) == \
            jsources.count_lines_file(str(p))
    for spec in (paths[0], paths):
        assert sources.text_spec(spec, 4, max_line_len=32) == \
            jsources.text_spec(spec, 4, max_line_len=32)
    for parts, n, w in (([0, 1], 8, 2), ([5, 6, 7], 8, 2), ([0], 6, 4),
                        ([], 8, 2), ([3], 8, 1)):
        assert sources.preferred_worker_for_partitions(parts, n, w) == \
            jsources.preferred_worker_for_partitions(parts, n, w)
    for path in (str(tmp_path / "x"), "s3://bkt/x"):
        assert sources.locality_hints_for_store(path, [0, 1]) == \
            jsources.locality_hints_for_store(path, [0, 1]) == []


def test_store_specs_equal_jax_on_either_packages_store(tmp_path):
    vals = {"k": np.arange(300, dtype=np.int32) % 7,
            "v": np.arange(300, dtype=np.int32)}
    port_store, jax_store = str(tmp_path / "p"), str(tmp_path / "j")
    Context(device="cpu", nparts=4).from_columns(vals).to_store(port_store)
    JContext().from_columns(vals).to_store(jax_store)
    for path in (port_store, jax_store):
        meta, jmeta = store_meta(path), jstore_meta(path)
        assert meta == jmeta
        for kw in ({}, {"partitions": [1, 2]}, {"capacity": 99},
                   {"partitions": [0], "preferred_worker": 1,
                    "preferred_hosts": ["h0"]}):
            for n in (DPP, meta["npartitions"]):
                assert sources.store_spec(path, n, meta, **kw) == \
                    jsources.store_spec(path, n, jmeta, **kw)
        for g, w in ((1, None), (2, 2), (3, 2)):
            assert sources.farm_store_tasks(
                path, "0:0", DPP, group_size=g, n_processes=w) == \
                jsources.farm_store_tasks(path, "0:0", DPP, group_size=g,
                                          n_processes=w)


def test_serialize_for_cluster_equals_jax():
    """The port's cluster plan is JAX's plan JSON with the package prefix
    rewritten, its specs JAX's; a PData source is DTA015 in both."""
    fake = types.SimpleNamespace(nparts=DPP, devices_per_process=DPP,
                                 n_processes=1)
    ctx, jctx = Context(cluster=fake), JContext(cluster=fake)
    plan, specs = serialize_for_cluster(
        plan_query(_query(ctx).node, DPP), ctx.fn_table)
    jplan, jspecs = jshiplan.serialize_for_cluster(
        jplan_query(_query(jctx).node, DPP, hosts=1), jctx.fn_table)
    assert plan == jplan.replace('"dryad_tpu.', '"dryad_tpu_torch.')
    assert '"torch_cluster_fns:double_v"' in plan
    assert specs.keys() == jspecs.keys()
    for k in specs:
        _same_spec(specs[k], jspecs[k])
    local = Context(device="cpu", nparts=DPP)
    with pytest.raises(PlanShipError) as ei:
        serialize_for_cluster(plan_query(_query(local).node, DPP))
    with pytest.raises(jshiplan.PlanShipError) as ej:
        jshiplan.serialize_for_cluster(
            jplan_query(_query(JContext()).node, 8))
    assert ei.value.code == ej.value.code == "DTA015"


@pytest.mark.parametrize("durations", [
    [1.0] * 4, [1.0] * 5, [0.2, 0.3, 0.25, 0.4, 5.0],
    [0.01, 0.012, 0.011, 0.013, 0.010, 0.2, 0.05],
    [3.0, 1.0, 2.0, 4.0, 10.0, 1.5]])
def test_speculation_threshold_equals_jax(durations):
    fake = types.SimpleNamespace(event_log=None)
    for kw in ({}, {"outlier_sigma": 1.0, "rel_margin": 0.1,
                    "abs_margin_s": 0.0}, {"min_samples": 3}):
        assert TaskFarm(fake, **kw)._threshold(durations) == \
            jfarm.TaskFarm(fake, **kw)._threshold(durations)


# -- the farm on worker processes ------------------------------------------------


def test_farm_results_equal_numpy_and_the_in_process_run(cluster):
    plan_json, src_key = _farm_plan(cluster)
    vals, per_task = _tasks(src_key, n_tasks=6)
    farm = TaskFarm(cluster)
    results = farm.run(plan_json, per_task)
    assert len(results) == 6
    _check(vals, results)
    for got, want in zip(results, _in_process(np.array_split(vals, 6))):
        assert np.array_equal(np.sort(got["v"]), np.sort(want["v"]))
    done = [e for e in farm.events if e["event"] == "task_done"]
    assert len(done) == 6 and all(set(e["launches"]) == {
        "hist_buckets", "prefix_sum", "prefix_sum2", "slot_expand",
        "slot_compact", "hash_keys", "seg_scan"} for e in done)
    # each task's run events come back in its own reply, tagged with its
    # worker; a farm task is a slice of the farm's job: no job_done
    stages = [e for e in farm.events if e.get("event") == "stage_done"]
    assert len(stages) >= 6 and all("worker" in e for e in stages)
    assert not [e for e in farm.events if e.get("event") == "job_done"]


def test_farm_speculates_on_a_straggler(cluster):
    plan_json, src_key = _farm_plan(cluster)
    TaskFarm(cluster).run(plan_json, _tasks(src_key, 4)[1])   # warm
    cluster.wait_quiescent()
    vals, per_task = _tasks(src_key, n_tasks=8)
    # every task on worker 1 sleeps 4 s, on worker 0 0.3 s: worker 1's
    # first task is the outlier, cloned once onto worker 0, which wins
    farm = TaskFarm(cluster, min_samples=3,
                    delay_hook=lambda task, pid: 4.0 if pid == 1 else 0.3)
    results = farm.run(plan_json, per_task)
    _check(vals, results)
    dups = [e for e in farm.events if e["event"] == "task_duplicated"]
    assert len(dups) == 1 and dups[0]["worker"] == 0, farm.events
    won = [e for e in farm.events if e["event"] == "task_done"
           and e["task"] == dups[0]["task"]]
    assert len(won) == 1 and won[0]["worker"] == 0 and won[0]["dup_won"]
    cluster.wait_quiescent(timeout=60)     # the loser drains


def test_farm_reassigns_a_killed_workers_task(cluster):
    plan_json, src_key = _farm_plan(cluster)
    TaskFarm(cluster).run(plan_json, _tasks(src_key, 4)[1])   # warm
    cluster.wait_quiescent()
    vals, per_task = _tasks(src_key, n_tasks=8)
    victim = cluster._procs[1].pid
    killer = threading.Timer(0.5, lambda: os.kill(victim, signal.SIGKILL))

    def delay(task, pid):
        # the kill lands while worker 1's first task (4 s) is in flight;
        # worker 0's tasks take 0.3 s, so worker 1 is dispatched one
        if pid == 1 and killer.ident is None:
            killer.start()
        return 4.0 if pid == 1 else 0.3

    farm = TaskFarm(cluster, min_samples=10**6, delay_hook=delay)
    try:
        results = farm.run(plan_json, per_task)
    finally:
        killer.cancel()
    _check(vals, results)
    moved = [e for e in farm.events if e["event"] == "task_reassigned"]
    assert len(moved) == 1 and moved[0]["worker"] == 1
    assert {e["worker"] for e in farm.events
            if e["event"] == "task_done"} == {0}
    assert not cluster.alive()
    # the next farm restarts the cluster
    _check(*(lambda v, t: (v, TaskFarm(cluster).run(plan_json, t)))(
        *_tasks(src_key, 4, seed=5)))
    assert cluster.alive()


def test_elastic_worker_joins_the_farm(cluster):
    plan_json, src_key = _farm_plan(cluster)
    new_pid = cluster.add_worker()
    assert new_pid >= cluster.n_processes
    try:
        vals, per_task = _tasks(src_key, n_tasks=12)
        farm = TaskFarm(cluster, delay_hook=lambda t, p: 0.3)
        _check(vals, farm.run(plan_json, per_task))
        assert new_pid in {e["worker"] for e in farm.events
                           if e["event"] == "task_done"}
    finally:
        cluster.restart()       # gang-only again for the later tests


def test_farm_over_store_partitions_with_locality(cluster, tmp_path):
    """One task per store partition, each carrying the worker that holds
    it (writer affinity): every task runs on its preferred worker."""
    path = str(tmp_path / "farm_store")
    vals = np.arange(480, dtype=np.int32) - 240
    Context(device="cpu", nparts=cluster.nparts).from_columns(
        {"v": vals}).to_store(path)
    plan_json, src_key = _farm_plan(cluster)
    cluster.wait_quiescent()
    per_task = sources.farm_store_tasks(path, src_key, DPP,
                                        n_processes=cluster.n_processes)
    prefs = [t[src_key]["preferred_worker"] for t in per_task]
    assert prefs == [0, 0, 1, 1]
    farm = TaskFarm(cluster, delay_hook=lambda t, p: 0.2)
    _check(vals, farm.run(plan_json, per_task))
    done = {e["task"]: e["worker"] for e in farm.events
            if e["event"] == "task_done"}
    assert sum(prefs[t] == w for t, w in done.items()) >= 3


def test_farm_hdfs_block_host_locality(cluster):
    """The whole chain with no hand-made hints: a store on the loopback
    WebHDFS fake whose even partitions' blocks sit on rack1-a and odd on
    rack1-b; ``farm_store_tasks`` reads the block locations into each
    task's ``preferred_hosts``; the farm resolves them against the
    worker -> host map; the workers read their partitions by ranged
    WebHDFS reads."""
    from webhdfs_fake import FakeWebHdfs

    def hosts_of(path, _block):
        p = int(path.rsplit("part-", 1)[1][:5])
        return ["rack1-a"] if p % 2 == 0 else ["rack1-b"]

    srv = FakeWebHdfs(block_hosts=hosts_of)
    try:
        vals = np.arange(400, dtype=np.int32) - 200
        Context(device="cpu", nparts=4).from_columns({"v": vals}) \
            .to_store(srv.url + "/farm/in")
        plan_json, src_key = _farm_plan(cluster)
        cluster.wait_quiescent()
        per_task = sources.farm_store_tasks(srv.url + "/farm/in", src_key,
                                            DPP)
        prefs = [{"rack1-a": 0, "rack1-b": 1}[
            t[src_key]["preferred_hosts"][0]] for t in per_task]
        assert prefs == [0, 1, 0, 1]
        farm = TaskFarm(cluster, worker_hosts={0: "RACK1-A.example.com",
                                               1: "rack1-b"},
                        delay_hook=lambda t, p: 0.2)
        _check(vals, farm.run(plan_json, per_task))
        done = {e["task"]: e["worker"] for e in farm.events
                if e["event"] == "task_done"}
        assert sum(prefs[t] == w for t, w in done.items()) >= 3
        assert any(e["event"] == "task_locality_dispatch"
                   for e in farm.events)
    finally:
        srv.close()


def test_gang_jobs_name_the_gang_half(cluster, tmp_path):
    """The terminals that refused before the gang half of item 11 now
    run as gang jobs and return the in-process results at the same
    ``nparts``; an elastic ``--standalone`` worker joined no gang and
    still refuses a ``run`` command."""
    from dryad_tpu_torch.io.store import store_meta
    gang = _query(Context(cluster=cluster))
    local = _query(Context(device="cpu", nparts=cluster.nparts))
    assert gang.ctx.nparts == cluster.nparts
    got, exp = gang.collect(), local.collect()
    np.testing.assert_array_equal(got["v"], exp["v"])
    assert gang.count() == local.count() == 3
    assert gang.sum("v") == local.sum("v") == 12
    np.testing.assert_array_equal(gang.cache().collect()["v"], exp["v"])
    gang.to_store(str(tmp_path / "s"))
    assert store_meta(str(tmp_path / "s"))["counts"] == [
        len(v) for v in np.array_split(np.arange(4), cluster.nparts)
        for v in [v[(v * 2) > 0]]]
    pid = cluster.add_worker()
    try:
        cluster.wait_quiescent()
        job = cluster.next_job_id()
        sock = cluster.sockets[pid]
        sock.setblocking(True)
        protocol.send_msg(sock, {"cmd": "run", "job": job})
        sock.setblocking(False)
        import select
        import time
        deadline, frames = time.time() + 30, []
        while not frames and time.time() < deadline:
            select.select([sock], [], [], 0.5)
            frames, ok = cluster.recv_frames(pid, job)
            assert ok
        assert frames and not frames[0]["ok"]
        assert "standalone (elastic) worker" in frames[0]["error"]
    finally:
        cluster._drop_elastic(pid)
