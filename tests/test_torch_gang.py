"""Gang SPMD jobs on ``LocalCluster(2, 4, device="cpu")``: the
counterparts of the 19 tests of ``tests/test_cluster.py``, and every
worker's stage log against the in-process one.  A cluster
Context spans the gang (P = 8: two worker processes, four partitions
each, the exchanges crossing them over gloo), and each result is held to
the port's in-process run at ``nparts=8`` — integers bit-exact, rows in
partition order — and to the JAX package's in-process run on the
conftest's 8 virtual CPU devices over the same seeded numpy inputs (as
rows in order where the query defines one, else as a row multiset; the
JAX tests run without x64).  The workers resolve their UDFs from
``tests/torch_cluster_fns.py``; the JAX runs use
``tests/cluster_fns.py``."""

import os
import signal
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cluster_fns as JF  # noqa: E402
import torch_cluster_fns as F  # noqa: E402

from dryad_tpu import Context as JContext  # noqa: E402
from dryad_tpu_torch import Context  # noqa: E402
from dryad_tpu_torch.io.store import store_meta  # noqa: E402
from dryad_tpu_torch.runtime import LocalCluster, WorkerFailure  # noqa: E402
from dryad_tpu_torch.utils.config import JobConfig  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

P = 8


def _env():
    old = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["PYTHONPATH"] = HERE + os.pathsep + (old["PYTHONPATH"] or "")
    os.environ["OMP_NUM_THREADS"] = "1"
    return old


def _restore(old):
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def cluster():
    old = _env()
    cl = LocalCluster(n_processes=2, devices_per_process=4,
                      fn_modules=("torch_cluster_fns",), device="cpu")
    yield cl
    cl.shutdown()
    _restore(old)


def _contexts(cluster, **kw):
    return (Context(cluster=cluster, **kw),
            Context(device="cpu", nparts=P, **kw))


def _same(a, b):
    """Two host tables equal column for column, rows in order."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], list):
            assert list(a[k]) == list(b[k]), k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def _rows(t, cols=None):
    cols = cols or sorted(t)
    return sorted(zip(*[[x if isinstance(x, bytes) else x.item()
                         for x in t[c]] for c in cols]))


def _gang_local(cluster, query, **kw):
    """query(ctx) run as a gang job and in process: both tables."""
    g, l = _contexts(cluster, **kw)
    out = query(g).collect()
    ref = query(l).collect()
    _same(out, ref)
    return out


def _expected_group(k, v):
    return {kk: int(v[k == kk].sum()) for kk in sorted(set(k.tolist()))}


def test_cluster_select_where_group(cluster):
    rng = np.random.default_rng(0)
    k = rng.integers(0, 13, 157).astype(np.int32)
    v = rng.integers(-5, 20, 157).astype(np.int32)

    def q(ctx, f):
        return (ctx.from_columns({"k": k, "v": v}).select(f.double_v)
                .where(f.keep_positive)
                .group_by(["k"], {"total": ("sum", "v"),
                                  "n": ("count", None)}))
    out = _gang_local(cluster, lambda c: q(c, F))
    mask = v * 2 > 0
    assert dict(zip(out["k"].tolist(), out["total"].tolist())) == \
        _expected_group(k[mask], (v * 2)[mask])
    assert _rows(out) == _rows(q(JContext(), JF).collect())


def test_cluster_orderby_and_scalars(cluster):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1_000_000, 211).astype(np.int32)
    out = _gang_local(cluster, lambda c: c.from_columns({"v": v})
                      .order_by([("v", False)]))
    np.testing.assert_array_equal(out["v"], np.sort(v))
    np.testing.assert_array_equal(
        out["v"], JContext().from_columns({"v": v})
        .order_by([("v", False)]).collect()["v"])
    g, l = _contexts(cluster)
    assert g.from_columns({"v": v}).count() == \
        l.from_columns({"v": v}).count() == 211
    assert g.from_columns({"v": v}).sum("v") == \
        l.from_columns({"v": v}).sum("v") == int(v.sum())


def test_cluster_join(cluster):
    def q(ctx):
        left = ctx.from_columns({"k": np.arange(40, dtype=np.int32),
                                 "a": np.arange(40, dtype=np.int32) * 10})
        right = ctx.from_columns({"k": np.arange(0, 80, 2, dtype=np.int32),
                                  "b": np.arange(40, dtype=np.int32) + 7})
        return left.join(right, ["k"], ["k"])
    out = _gang_local(cluster, q)
    assert sorted(out["k"].tolist()) == list(range(0, 40, 2))
    assert all(a == kk * 10 and b == kk // 2 + 7
               for kk, a, b in zip(out["k"], out["a"], out["b"]))
    assert _rows(out) == _rows(q(JContext()).collect())


def test_cluster_store_roundtrip(cluster, tmp_path):
    g, l = _contexts(cluster)
    k = np.arange(60, dtype=np.int32) % 7
    v = np.arange(60, dtype=np.int32)
    for ctx, name in ((g, "gang"), (l, "local")):
        ctx.from_columns({"k": k, "v": v}).hash_partition(["k"]).to_store(
            str(tmp_path / name))
    # the same store, byte for byte, with its hash claim
    gm, lm = (store_meta(str(tmp_path / n)) for n in ("gang", "local"))
    assert gm == lm and gm["partitioning"] == {"kind": "hash",
                                                "keys": ["k"]}
    out = (g.from_store(str(tmp_path / "gang"))
           .group_by(["k"], {"total": ("sum", "v")})).collect()
    _same(out, (l.from_store(str(tmp_path / "local"))
                .group_by(["k"], {"total": ("sum", "v")})).collect())
    assert dict(zip(out["k"].tolist(), out["total"].tolist())) == \
        _expected_group(k, v)
    plan = (g.from_store(str(tmp_path / "gang"))
            .group_by(["k"], {"total": ("sum", "v")})).explain()
    assert "=>hash" not in plan


def test_cluster_parallel_store_output_gzip(cluster, tmp_path):
    """Each worker writes its own partitions (gzip included); worker 0
    merges the meta and commits.  The store equals the in-process one,
    and reads back in the JAX package."""
    from dryad_tpu.io.store import store_meta as jstore_meta
    g, l = _contexts(cluster)
    k = np.arange(200, dtype=np.int32) % 9
    v = np.arange(200, dtype=np.int32)
    for ctx, name in ((g, "gz"), (l, "gz_local")):
        (ctx.from_columns({"k": k, "v": v}).hash_partition(["k"])
         .to_store(str(tmp_path / name), compression="gzip"))
    meta = store_meta(str(tmp_path / "gz"))
    assert meta == store_meta(str(tmp_path / "gz_local"))
    assert meta["compression"] == "gzip"
    assert meta["npartitions"] == cluster.nparts == P
    assert sum(meta["counts"]) == 200
    for p in range(P):
        name = f"part-{p:05d}.bin"
        with open(tmp_path / "gz" / name, "rb") as a, \
                open(tmp_path / "gz_local" / name, "rb") as b:
            assert a.read() == b.read()
    assert jstore_meta(str(tmp_path / "gz")) == meta
    back = JContext().from_store(str(tmp_path / "gz")).collect()
    assert _rows(back, ["k", "v"]) == sorted(zip(k.tolist(), v.tolist()))


def test_cluster_worker_failure_detection_and_restart(cluster):
    ctx = Context(cluster=cluster)
    v = np.arange(100, dtype=np.int32)
    assert ctx.from_columns({"v": v}).count() == 100
    os.kill(cluster._procs[1].pid, signal.SIGKILL)
    cluster._procs[1].wait(timeout=10)
    with pytest.raises(WorkerFailure):
        cluster._check_deaths()
    assert not cluster.alive()
    # the next job restarts the gang and runs from its sources
    assert ctx.from_columns({"v": v}).count() == 100
    assert cluster.alive()


def test_cluster_read_text_multifile(cluster, tmp_path):
    (tmp_path / "a.txt").write_text("one two\nthree\n")
    (tmp_path / "b.txt").write_text("four\nfive six seven\n")
    g, l = _contexts(cluster)
    assert g.read_text(str(tmp_path / "*.txt")).count() == 4
    out = _gang_local(cluster, lambda c: c.read_text(
        str(tmp_path / "*.txt")).split_words("line", out_capacity=256)
        .group_by(["line"], {"n": ("count", None)}))
    assert sorted(out["n"].tolist()) == [1] * 7
    j = (JContext().read_text(str(tmp_path / "*.txt"))
         .split_words("line", out_capacity=256)
         .group_by(["line"], {"n": ("count", None)})).collect()
    assert _rows(out) == _rows(j)


def test_cluster_do_while(cluster):
    def run(ctx, f):
        init = ctx.from_columns({"v": np.arange(8, dtype=np.int32)})
        return ctx.do_while(init, lambda d: d.select(f.inc_v), n_iters=5,
                            cond=lambda t: int(max(t["v"])) < 10).collect()
    g, l = _contexts(cluster)
    out = run(g, F)
    _same(out, run(l, F))
    np.testing.assert_array_equal(np.sort(out["v"]), np.arange(8) + 3)
    np.testing.assert_array_equal(np.sort(run(JContext(), JF)["v"]),
                                  np.sort(out["v"]))


def test_cluster_setops_and_group_join(cluster):
    def sets(ctx):
        a = ctx.from_columns({"k": np.arange(30, dtype=np.int32)})
        b = ctx.from_columns({"k": np.arange(20, 50, dtype=np.int32)})
        return a.intersect(b), a.except_(b)

    g, l = _contexts(cluster)
    for dg, dl, dj, exp in zip(sets(g), sets(l), sets(JContext()),
                               (range(20, 30), range(20))):
        out = dg.collect()
        _same(out, dl.collect())
        assert sorted(out["k"].tolist()) == list(exp)
        assert _rows(out) == _rows(dj.collect())

    def gj(ctx):
        left = ctx.from_columns({"k": np.arange(3, dtype=np.int32)})
        right = ctx.from_columns({"k": np.arange(10, dtype=np.int32) % 3,
                                  "v": np.arange(10, dtype=np.int32)})
        return left.group_join(right, ["k"], {"total": ("sum", "v"),
                                              "n": ("count", None)})
    out = _gang_local(cluster, gj)
    ks, vs = np.arange(10) % 3, np.arange(10)
    assert {int(k): (int(t), int(n)) for k, t, n in
            zip(out["k"], out["total"], out["n"])} == {
        kk: (int(vs[ks == kk].sum()), int((ks == kk).sum()))
        for kk in range(3)}
    assert _rows(out) == _rows(gj(JContext()).collect())


def test_cluster_registered_decomposable(cluster):
    """A user Decomposable shipped by name: ``Context(fn_table=)`` on the
    driver, the worker's ``--fn-module``'s FN_TABLE."""
    k = np.arange(40, dtype=np.int32) % 5
    v = np.arange(40, dtype=np.int32)
    out = _gang_local(
        cluster, lambda c: c.from_columns({"k": k, "v": v}).group_by(
            ["k"], {"s": F.SUM_DEC}), fn_table={"sum_dec": F.SUM_DEC})
    assert dict(zip(out["k"].tolist(), out["s"].tolist())) == \
        {kk: int(v[k == kk].sum()) for kk in range(5)}
    j = JContext(fn_table={"sum_dec": JF.SUM_DEC}).from_columns(
        {"k": k, "v": v}).group_by(["k"], {"s": JF.SUM_DEC}).collect()
    assert _rows(out) == _rows(j)


def test_cluster_zip_strings_take(cluster):
    words = [f"w{i:03d}" for i in range(40)]

    def z(ctx):
        return ctx.from_columns({"s": words}).zip_with(
            ctx.from_columns({"x": np.arange(40, dtype=np.int32) * 2}))
    out = _gang_local(cluster, z)
    assert [w.decode() for w in out["s"]] == words
    np.testing.assert_array_equal(out["x"], np.arange(40) * 2)
    _same(out, z(JContext()).collect())

    def top(ctx):
        return (ctx.from_columns({"s": words[::-1]})
                .order_by([("s", False)]).take(5))
    t = _gang_local(cluster, top)
    assert [w.decode() for w in t["s"]] == words[:5]
    _same(t, top(JContext()).collect())


def test_cluster_do_while_resident_state(cluster, monkeypatch):
    """Loop state stays resident on the workers: after the init's
    shipment each iteration's message carries only the plan and the
    token, never the table."""
    import pickle

    from dryad_tpu_torch.runtime import cluster as cluster_mod
    sizes = []
    real_send = cluster_mod.protocol.send_msg

    def counting_send(sock, obj):
        if isinstance(obj, dict) and obj.get("cmd") == "run":
            sizes.append(len(pickle.dumps(obj, protocol=4)))
        return real_send(sock, obj)

    monkeypatch.setattr(cluster_mod.protocol, "send_msg", counting_send)
    g, l = _contexts(cluster)
    n = 50_000
    res = []
    for ctx in (g, l):
        init = ctx.from_columns({"v": np.arange(n, dtype=np.int32)})
        res.append(ctx.do_while(init, lambda d: d.select(F.inc_v),
                                n_iters=4).collect())
    _same(*res)
    np.testing.assert_array_equal(np.sort(res[0]["v"]), np.arange(n) + 4)
    per_job = sizes[::cluster.n_processes]
    assert len(per_job) == 6          # init, 4 iterations, the collect
    assert per_job[0] > n
    assert all(s < 20_000 for s in per_job[1:]), per_job


def test_cluster_cache_keeps_partitioning(cluster):
    """cache() stays resident and keeps its hash claim: a group_by on the
    same keys plans no exchange."""
    k = (np.arange(120, dtype=np.int32) * 7) % 13
    v = np.arange(120, dtype=np.int32)
    g, l = _contexts(cluster)
    cached = [ctx.from_columns({"k": k, "v": v}).hash_partition(["k"])
              .cache() for ctx in (g, l)]
    assert "=>hash" not in cached[0].group_by(
        ["k"], {"s": ("sum", "v")}).explain()
    outs = [c.group_by(["k"], {"s": ("sum", "v")}).collect()
            for c in cached]
    _same(*outs)
    assert dict(zip(outs[0]["k"].tolist(), outs[0]["s"].tolist())) == \
        {int(kk): int(v[k == kk].sum()) for kk in np.unique(k)}


def test_cluster_cache_survives_gang_restart(cluster):
    """A restart wipes the workers' resident state; the cached Dataset
    heals through MissingResidentToken by re-running its producer."""
    events = []
    ctx = Context(cluster=cluster, event_log=events.append)
    k = np.arange(90, dtype=np.int32) % 5
    v = np.arange(90, dtype=np.int32)
    cached = ctx.from_columns({"k": k, "v": v}).cache()
    before = cached.group_by(["k"], {"s": ("sum", "v")}).collect()
    cluster.restart()
    after = cached.group_by(["k"], {"s": ("sum", "v")}).collect()
    _same(after, before)
    assert any(e.get("event") == "job_failed"
               and "MissingResidentToken" in e.get("error", "")
               for e in events)


def test_cluster_group_contents(cluster):
    rng = np.random.default_rng(7)
    k = rng.integers(0, 6, 90).astype(np.int32)
    v = rng.integers(-50, 50, 90).astype(np.int32)

    def src(ctx):
        return ctx.from_columns({"k": k, "v": v})
    out = _gang_local(cluster, lambda c: src(c).group_top_k(["k"], 2, "v"))
    got = {}
    for kk, vv in zip(out["k"], out["v"]):
        got.setdefault(int(kk), []).append(int(vv))
    assert {kk: sorted(g, reverse=True) for kk, g in got.items()} == {
        int(kk): sorted(v[k == kk].tolist(), reverse=True)[:2]
        for kk in np.unique(k)}
    assert _rows(out) == _rows(src(JContext()).group_top_k(
        ["k"], 2, "v").collect())
    med = _gang_local(cluster, lambda c: src(c).group_median(["k"], "v"))
    assert dict(zip(med["k"].tolist(), med["v"].tolist())) == {
        int(kk): int(np.sort(v[k == kk])[(np.sum(k == kk) - 1) // 2])
        for kk in np.unique(k)}
    sec = _gang_local(cluster, lambda c: src(c).group_apply(
        ["k"], F.second_largest, group_capacity=64))
    j = src(JContext()).group_apply(["k"], JF.second_largest,
                                    group_capacity=64).collect()
    assert _rows(sec) == _rows(j)


def test_cluster_outer_joins(cluster):
    def q(ctx):
        left = ctx.from_columns({"k": np.arange(20, dtype=np.int32),
                                 "a": np.arange(20, dtype=np.int32) * 2})
        right = ctx.from_columns({"k": np.arange(10, 30, dtype=np.int32),
                                  "b": np.arange(20, dtype=np.int32) + 5})
        return left.join(right, ["k"], expansion=4.0, how="full")
    out = _gang_local(cluster, q)
    assert sorted(out["k"].tolist()) == list(range(30))
    for kk, a, b in zip(out["k"], out["a"], out["b"]):
        assert int(a) == (kk * 2 if kk < 20 else 0)
        assert int(b) == (kk - 10 + 5 if kk >= 10 else 0)
    assert _rows(out) == _rows(q(JContext()).collect())


def test_cluster_scalar_ships_one_row(cluster, monkeypatch):
    """A scalar ships a constant-key group-by: ONE row crosses the
    control plane, and the values equal the in-process scalars."""
    from dryad_tpu_torch.runtime import cluster as cluster_mod
    rng = np.random.default_rng(5)
    v = rng.integers(-100, 100, 500).astype(np.int32)
    g, l = _contexts(cluster)
    rows = []
    real = cluster_mod.LocalCluster.execute

    def counting(self, *a, **kw):
        reply = real(self, *a, **kw)
        rows.append(len(next(iter(reply["table"].values()))))
        return reply

    monkeypatch.setattr(cluster_mod.LocalCluster, "execute", counting)
    for kind in ("sum", "min", "max"):
        assert getattr(g.from_columns({"v": v}), kind)("v") == \
            getattr(l.from_columns({"v": v}), kind)("v") == \
            int(getattr(v, kind)())
    assert abs(float(g.from_columns({"v": v}).mean("v"))
               - float(v.mean())) < 1e-3
    assert rows == [1] * 4
    j = JContext().from_columns({"v": v})
    assert int(j.sum("v")) == int(g.from_columns({"v": v}).sum("v"))


def test_gang_straggler_watchdog_replays():
    """A frozen worker (its heartbeats stop) is declared wedged within
    the heartbeat envelope, the gang is torn down, and the job replays on
    a fresh gang: nowhere near the job timeout."""
    import time
    old = _env()
    cl = LocalCluster(n_processes=2, devices_per_process=4, device="cpu")
    try:
        cfg = JobConfig(cluster_job_timeout_s=600.0, gang_heartbeat_s=0.5,
                        gang_heartbeat_timeout_s=6.0,
                        gang_straggler_abs_margin_s=5.0)
        events = []
        ctx = Context(cluster=cl, config=cfg, event_log=events.append)
        v = np.arange(4000, dtype=np.int32)
        assert ctx.from_columns({"v": v}).count() == 4000
        os.kill(cl._procs[1].pid, signal.SIGSTOP)
        t0 = time.time()
        out = ctx.from_columns({"v": v}).group_by(
            ["v"], {"n": ("count", None)}).count()
        assert out == 4000
        assert time.time() - t0 < 60
        wedges = [e for e in events if e.get("event") == "worker_wedged"]
        assert wedges and 1 in wedges[0]["workers"]
    finally:
        for p in cl._procs:
            try:
                os.kill(p.pid, signal.SIGCONT)
            except OSError:
                pass
        cl.shutdown()
        _restore(old)


def test_gang_slow_but_beating_worker_not_wedged(monkeypatch):
    """A slow member whose heartbeats keep flowing is not declared wedged
    by the straggler margin."""
    old = _env()
    monkeypatch.setenv("DRYAD_TEST_REPLY_DELAY", "1:5")
    cl = LocalCluster(n_processes=2, devices_per_process=4, device="cpu")
    try:
        cfg = JobConfig(cluster_job_timeout_s=600.0, gang_heartbeat_s=0.5,
                        gang_heartbeat_timeout_s=60.0,
                        gang_straggler_rel_margin=0.0,
                        gang_straggler_abs_margin_s=2.0)
        events = []
        ctx = Context(cluster=cl, config=cfg, event_log=events.append)
        v = np.arange(1000, dtype=np.int32)
        assert ctx.from_columns({"v": v}).count() == 1000
        assert not [e for e in events
                    if e.get("event") == "worker_wedged"]
    finally:
        cl.shutdown()
        _restore(old)


def test_cluster_stage_logs_equal_in_process(cluster):
    """A gang job takes the in-process run's decisions: a 95 %-hot join
    overflows unsalted and salts at attempt 2, and every worker's stage
    log equals the in-process log in attempts, scale, slack, salting,
    send slots and their sources, and received rows per partition."""
    rng = np.random.default_rng(11)
    k = rng.integers(1, 400, 4_000).astype(np.int32)
    k[rng.random(4_000) < 0.95] = 0
    keep = ("label", "attempts", "scale", "slack", "salted",
            "salted_attempts", "slot_rows", "slot_source", "recv_rows")

    def q(ctx):
        return ctx.from_columns({"k": k, "i": np.arange(4_000,
                                                         dtype=np.int32)}
                                ).join(ctx.from_columns(
                                    {"k": np.arange(400, dtype=np.int32),
                                     "w": np.arange(400, dtype=np.int32)}),
                                    ["k"], ["k"])
    g, l = _contexts(cluster)
    reply = g._cluster_run(q(g).node, want_reply=True)
    local = q(l)
    _same(reply["table"], local.collect())
    want = [{f: e[f] for f in keep} for e in l.executor.stage_log]
    (join,) = [e for e in want if e["label"] == "join"]
    assert join["salted"] and join["attempts"] == 2
    for w, info in reply["workers"].items():
        assert [{f: e[f] for f in keep} for e in info["stage_log"]] == \
            want, w
