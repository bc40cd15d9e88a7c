"""Multi-axis meshes and hierarchical group aggregation in the port
(``parallel/mesh.make_mesh``, ``Context(mesh=)``, the planner's levels,
``shuffle.hash_exchange(axis=)``, ``adapt/manager.levels_of_mesh``),
against the JAX package on the conftest's 8 virtual CPU devices: the
counterparts of ``tests/test_multihost.py`` (without its
``__graft_entry__`` dry runs), of ``tests/test_decomposable.py``'s 2-D
decomposable and of ``tests/test_adapt.py``'s levels and collapse tests
(with the expansion end to end on a one-level plan),
then the same on a gang (``LocalCluster(2, 4, device="cpu")``, whose
mesh is ``(dcn, dp)`` with ``dcn`` the process boundary).

Tolerances: keys, counts, integer sums, min / max and moved values are
exact; an f32 group sum is within 16 x 2**-24 x sum_group |v| of the
float64 sum (the levels add partials in another tree than one exchange
does), a mean within that bound / count; the decomposable variance
within JAX's own test's rtol 2e-3, atol 1e-5 of numpy."""

import collections
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dryad_tpu import Context as JContext
from dryad_tpu import Decomposable as JDec
from dryad_tpu.adapt.manager import levels_of_mesh as jlevels_of_mesh
from dryad_tpu.parallel.mesh import axis_sizes as jaxis_sizes
from dryad_tpu.parallel.mesh import make_mesh as jmake_mesh
from dryad_tpu.parallel.mesh import mesh_axes as jmesh_axes
from dryad_tpu_torch import Context, Decomposable, JobConfig, make_mesh
from dryad_tpu_torch.adapt.manager import levels_of_mesh
from dryad_tpu_torch.exec.data import pdata_from_host, split_partitions
from dryad_tpu_torch.ops import hopper_kernels as hk
from dryad_tpu_torch.ops.hashing import hash_batch_keys
from dryad_tpu_torch.parallel import shuffle
from dryad_tpu_torch.parallel.mesh import Mesh, axis_sizes, mesh_axes
from tests.torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
EPS = 2.0**-24
SHAPES = [dict(), dict(hosts=2), dict(hosts=4), dict(hosts=2, pods=2)]


def _mesh2():
    return make_mesh("cpu", 8, hosts=2)


def _jctx(**kw):
    return JContext(mesh=jmake_mesh(jax.devices(), **kw))


def _mk(c, n=240, seed=0):
    rng = np.random.RandomState(seed)
    cols = {"k": rng.randint(0, 15, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32)}
    return c.from_columns(cols, capacity=48), cols


def _rows(t, cols=None):
    cols = cols or sorted(t)
    return sorted(zip(*[[x if isinstance(x, bytes) else np.asarray(x)
                         .item() for x in t[c]] for c in cols]))


def _by_key(t, key="k"):
    ks = np.asarray(t[key]).tolist()
    return {kk: {c: np.asarray(t[c])[i].item() for c in t if c != key}
            for i, kk in enumerate(ks)}


def _check_groups(got, k, v, jax_out=None):
    """count exact, f32 sum / mean within the stated bound, per key."""
    g = _by_key(got)
    assert sorted(g) == sorted(set(k.tolist()))
    for kk, row in g.items():
        sel = v[k == kk].astype(np.float64)
        bound = 16 * EPS * np.abs(sel).sum()
        assert row["n"] == len(sel)
        assert abs(row["s"] - sel.sum()) <= bound
        if "m" in row:
            assert abs(row["m"] - sel.mean()) <= bound / len(sel) + 1e-12
    if jax_out is not None:
        j = _by_key(jax_out)
        assert sorted(j) == sorted(g)
        for kk in g:
            assert g[kk]["n"] == j[kk]["n"]


# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("kw", SHAPES)
def test_make_mesh_equals_jax(devices8, kw):
    t, j = make_mesh("cpu", 8, **kw), jmake_mesh(devices8, **kw)
    assert mesh_axes(t) == t.axis_names == tuple(jmesh_axes(j))
    assert axis_sizes(t) == {a: int(z) for a, z in jaxis_sizes(j).items()}
    assert t.nparts == 8 and t.world == 1
    assert levels_of_mesh(t) == tuple(
        (a, int(z)) for a, z in jlevels_of_mesh(j))
    # a partition's index is mixed-radix over the axes, innermost least
    # significant, as the JAX mesh lays its devices out
    ids = np.asarray([d.id for d in j.devices.flat]).reshape(
        j.devices.shape)
    for p in range(8):
        coord = tuple(int(x) for x in np.argwhere(ids == p)[0])
        assert coord == tuple((p // t.axis_radix(a)) % t.axis_size(a)
                              for a in t.axis_names)


@pytest.mark.parametrize("kw", [dict(hosts=3), dict(pods=2),
                                dict(hosts=3, pods=2)])
def test_make_mesh_refuses_what_jax_refuses(devices8, kw):
    with pytest.raises(ValueError):
        jmake_mesh(devices8, **kw)
    with pytest.raises(ValueError):
        make_mesh("cpu", 8, **kw)


def test_mesh_axes_take_part_in_equality():
    a, b = make_mesh("cpu", 8), _mesh2()
    assert a != b and hash(a) != hash(b) and _mesh2() == b
    assert len({a: 1, b: 2, _mesh2(): 3}) == 2
    # a gang's default axes: the process boundary outermost
    g = Mesh(torch.device("cpu"), 8, rank=1, world=2)
    assert g.axes == (("dcn", 2), ("dp", 4))
    assert levels_of_mesh(g) == (("dp", 4), ("dcn", 2))
    with pytest.raises(ValueError):
        Mesh(torch.device("cpu"), 8, rank=0, world=2,
             axes=(("dp", 4), ("dcn", 2)))
    with pytest.raises(ValueError):
        Mesh(torch.device("cpu"), 8, axes=(("dcn", 3), ("dp", 3)))


def test_mesh_shape(devices8):
    ctx = Context(mesh=_mesh2())
    jctx = _jctx(hosts=2)
    assert ctx.hosts == jctx.hosts == 2
    assert ctx.nparts == jctx.nparts == 8
    assert ctx.mesh.axis_names == tuple(jctx.mesh.axis_names) == \
        ("dcn", "dp")
    assert ctx.levels == jctx.levels == ("dp", "dcn")
    three = Context(mesh=make_mesh("cpu", 8, hosts=2, pods=2))
    assert three.levels == _jctx(hosts=2, pods=2).levels
    flat = Context(device="cpu", nparts=8)
    assert (flat.hosts, flat.levels) == (1, ())


def test_context_refuses_a_contradicting_device_or_nparts():
    with pytest.raises(ValueError, match="contradicts"):
        Context(nparts=4, mesh=_mesh2())
    with pytest.raises(ValueError, match="contradicts"):
        Context(device="cuda", mesh=_mesh2())
    assert Context(device="cpu", nparts=8, mesh=_mesh2()).nparts == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Context()


# ---------------------------------------------------------------------------
# the axis exchange on one card


def test_axis_hops_place_rows_and_launch_each_kernel_once():
    """A (dcn, dp) mesh's ``dp`` hop keeps a row's dcn coordinate and
    takes lo % 4 as its dp one; the ``dcn`` hop then takes (lo // 4) % 2:
    every row ends at lo % 8, the global exchange's partition, in the
    same order.  Each hop is one launch of each of the four exchange
    kernels (``hist_buckets``, ``prefix_sum``, ``slot_expand``,
    ``slot_compact``; on the CPU the wrappers' captured calls)."""
    mesh = _mesh2()
    rng = np.random.default_rng(5)
    pd = pdata_from_host({"k": rng.integers(-900, 900, 700).astype(
        np.int32), "i": np.arange(700, dtype=np.int32)}, mesh, capacity=96)
    parts = split_partitions(pd)
    hk.capture = {}
    try:
        mid, nr, nsl, _ = shuffle.hash_exchange(parts, ["k"], 400,
                                                mesh=mesh, axis="dp")
        calls = {k: len(v) for k, v in hk.capture.items()}
    finally:
        hk.capture = None
    assert calls == dict.fromkeys(("hist_buckets", "prefix_sum",
                                   "slot_expand", "slot_compact"), 1)
    assert int(nr) == 0 and int(nsl) == 0
    src_of = {i: p for p, b in enumerate(parts)
              for i in b.columns["i"][:int(b.count)].tolist()}
    for d, b in enumerate(mid):
        lo = hash_batch_keys(b, ["k"])[1][:int(b.count)]
        ids = b.columns["i"][:int(b.count)].tolist()
        assert all(d // 4 == src_of[i] // 4 for i in ids)
        assert ((lo % 4) == d % 4).all()
        # rows in global source order
        assert [src_of[i] for i in ids] == sorted(src_of[i] for i in ids)
    out, _, _, _ = shuffle.hash_exchange(mid, ["k"], 800, mesh=mesh,
                                         axis="dcn")
    glob, _, _, _ = shuffle.hash_exchange(parts, ["k"], 800, mesh=mesh)
    for a, b in zip(out, glob):
        assert int(a.count) == int(b.count)
        n = int(a.count)
        assert a.columns["i"][:n].tolist() == b.columns["i"][:n].tolist()
    with pytest.raises(ValueError, match="axis 'host'"):
        shuffle.hash_exchange(parts, ["k"], 800, mesh=mesh, axis="host")


def test_axis_hop_probe_counts_its_axis():
    """A pure hash leg over a mesh axis (the ``dcn`` combine stage) is
    probed by its rows' coordinate on the axis: the slot it ships is the
    measured one, quantized, far below the structural slack x cap /
    |dcn|, no attempt retries, and the table equals the unprobed run's
    row for row."""
    probed = Context(mesh=_mesh2(), config=JobConfig(exchange_probe_min_mb=0))
    q, _k, _v = _group_query(probed)
    got = q.collect()
    dp, dcn = probed.executor.stage_log
    assert dcn["slot_source"] == [["probe"]] and dcn["probes"] == 1
    assert dcn["attempts"] == 1
    # 6,000 rows in 8 partitions of 750: the structural slot is
    # 2 x 750 / |dcn| = 750 rows
    assert 16 <= dcn["slot_rows"][0][0] < 750
    assert dcn["slot_rows"][0][0] >= max(dcn["recv_rows"][0]) // 4
    _same(got, _group_query(Context(mesh=_mesh2()))[0].collect())


# ---------------------------------------------------------------------------
# tests/test_multihost.py's counterparts


def test_hierarchical_groupby(devices8):
    ctx, jctx = Context(mesh=_mesh2()), _jctx(hosts=2)

    def q(d):
        return d.group_by(["k"], {"n": ("count", None), "s": ("sum", "v"),
                                  "m": ("mean", "v")})
    a, cols = _mk(ctx)
    plan = q(a).explain()
    assert "groupby-dp" in plan and "groupby-dcn" in plan
    assert plan == q(_mk(jctx)[0]).explain()
    got = q(a).collect()
    assert [e["label"] for e in ctx.executor.stage_log] == \
        ["groupby-dp", "groupby-dcn"]
    flat = q(_mk(Context(device="cpu", nparts=8))[0]).collect()
    _check_groups(got, cols["k"], cols["v"], q(_mk(jctx)[0]).collect())
    _check_groups(flat, cols["k"], cols["v"])


def test_global_sort_2hop(devices8):
    got = _mk(Context(mesh=_mesh2()))[0].order_by([("v", False)]).collect()
    exp = _mk(_jctx(hosts=2))[0].order_by([("v", False)]).collect()
    assert _rows(got, ["v", "k"]) == _rows(exp, ["v", "k"])
    np.testing.assert_array_equal(got["v"], np.asarray(exp["v"]))
    np.testing.assert_array_equal(got["k"], np.asarray(exp["k"]))


def _dim_join(d, broadcast=False):
    dim = d.ctx.from_columns(
        {"k": np.arange(15, dtype=np.int32),
         "t": (np.arange(15) * 3).astype(np.int32)}, capacity=4)
    return d.join(dim, ["k"], expansion=3.0, broadcast=broadcast)


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["join_2hop", "broadcast_2d"])
def test_join_2hop_and_broadcast_2d(devices8, broadcast):
    got = _dim_join(_mk(Context(mesh=_mesh2()))[0], broadcast).collect()
    exp = _dim_join(_mk(_jctx(hosts=2))[0], broadcast).collect()
    assert _rows(got) == _rows(exp) and len(got["k"]) == 240


def test_wordcount_2d(devices8):
    lines = [b"alpha beta gamma", b"beta gamma", b"alpha alpha"] * 16

    def build(c):
        return (c.from_columns({"line": lines}, str_max_len=32)
                .split_words("line", out_capacity=64)
                .group_by(["line"], {"n": ("count", None)}))
    ctx = Context(mesh=_mesh2())
    got = build(ctx).collect()
    assert _rows(got) == _rows(build(_jctx(hosts=2)).collect()) == \
        [(b"alpha", 48), (b"beta", 32), (b"gamma", 32)]
    assert [e["label"] for e in ctx.executor.stage_log] == \
        ["groupby-dp", "groupby-dcn"]


def test_three_level_mesh_hierarchical_paths(devices8):
    mesh = make_mesh("cpu", 8, hosts=2, pods=2)
    assert mesh.axis_names == ("dcn", "host", "dp")
    events = []
    ctx = Context(mesh=mesh, event_log=events.append)
    rng = np.random.RandomState(2)
    n = 640
    k = rng.randint(0, 7, n).astype(np.int32)
    v = rng.randn(n).astype(np.float32)
    ds = ctx.from_columns({"k": k, "v": v})
    t = ds.group_by(["k"], {"n": ("count", None), "s": ("sum", "v")}) \
        .collect()
    assert dict(zip(t["k"].tolist(), t["n"].tolist())) == \
        dict(collections.Counter(k.tolist()))
    jt = _jctx(hosts=2, pods=2).from_columns({"k": k, "v": v}).group_by(
        ["k"], {"n": ("count", None), "s": ("sum", "v")}).collect()
    _check_groups(t, k, v, jt)
    labels = [e["label"] for e in events if e.get("event") == "stage_done"]
    assert labels == ["groupby-dp", "groupby-host", "groupby-dcn"]
    ts = ds.order_by([("v", False)]).collect()
    vv = np.asarray(ts["v"])
    assert (vv[:-1] <= vv[1:]).all() and len(vv) == n
    np.testing.assert_array_equal(vv, np.sort(v))


# ---------------------------------------------------------------------------
# tests/test_decomposable.py and tests/test_adapt.py counterparts


def _variance(torch_side: bool):
    if torch_side:
        return Decomposable(
            seed=lambda c: (torch.ones(c["v"].shape[0], dtype=torch.float32,
                                       device=c["v"].device),
                            c["v"], c["v"] * c["v"]),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2]),
            finalize=lambda s: s[2] / torch.clamp(s[0], min=1)
            - (s[1] / torch.clamp(s[0], min=1)) ** 2)
    return JDec(
        seed=lambda c: (jnp.ones(c["v"].shape[0], jnp.float32),
                        c["v"], c["v"] * c["v"]),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2]),
        finalize=lambda s: s[2] / jnp.maximum(s[0], 1)
        - (s[1] / jnp.maximum(s[0], 1)) ** 2)


def test_multihost_hierarchical_decomposable(devices8):
    """2-D mesh: a decomposable aggregate lowers to a dp merge, then a
    dcn merge that finalizes, and stays correct."""
    def run(c, torch_side):
        rng = np.random.RandomState(5)
        cols = {"k": rng.randint(0, 7, 220).astype(np.int32),
                "v": rng.randn(220).astype(np.float32)}
        ds = c.from_columns(cols, capacity=96)
        q = ds.group_by(["k"], {"var": _variance(torch_side)})
        return q.explain(), q.collect(), cols
    ctx = Context(mesh=_mesh2())
    plan, out, cols = run(ctx, True)
    jplan, jout, _ = run(_jctx(hosts=2), False)
    assert plan == jplan and "dgroupby-dp" in plan and "dgroupby-dcn" in plan
    assert [e["label"] for e in ctx.executor.stage_log] == \
        ["dgroupby-dp", "dgroupby-dcn"]
    keys, var = np.asarray(out["k"]), np.asarray(out["var"])
    order = np.argsort(keys)
    uk = np.unique(cols["k"])
    np.testing.assert_array_equal(keys[order], uk)
    exp = np.array([cols["v"][cols["k"] == kk].astype(np.float64).var()
                    for kk in uk])
    np.testing.assert_allclose(var[order], exp, rtol=2e-3, atol=1e-5)
    jk = np.asarray(jout["k"])
    np.testing.assert_allclose(var[order], np.asarray(jout["var"])[
        np.argsort(jk)], rtol=2e-3, atol=1e-5)


def test_levels_of_mesh_orientation(devices8):
    lv = levels_of_mesh(_mesh2())
    assert [name for name, _ in lv] == ["dp", "dcn"]  # innermost first
    assert lv[-1][1] == 2
    assert lv == tuple((a, int(z)) for a, z in jlevels_of_mesh(
        jmake_mesh(devices8, hosts=2)))
    assert levels_of_mesh(None) == ()


def _two_groups(ctx):
    rng = np.random.default_rng(1)
    n = 20_000
    k = rng.integers(0, 50, n).astype(np.int32)
    v = rng.integers(0, 10, n).astype(np.int32)
    return (ctx.from_columns({"k": k, "v": v})
            .group_by(["k"], {"s": ("sum", "v")})
            .group_by(["s"], {"n": ("count", None)}))


def _rewrites(events):
    return [e for e in events if e.get("event") == "graph_rewrite"]


def _stages_run(events):
    return {e["stage"] for e in events if e.get("event") == "stage_done"}


def test_e2e_agg_tree_collapse_runs_fewer_stages(devices8):
    ev_on, ev_off, jev = [], [], []
    on = _two_groups(Context(mesh=_mesh2(), event_log=ev_on.append,
                             config=JobConfig(adaptive="on"))).collect()
    off = _two_groups(Context(mesh=_mesh2(), event_log=ev_off.append)
                      ).collect()
    from dryad_tpu.utils.config import JobConfig as JJobConfig
    jon = _two_groups(JContext(mesh=jmake_mesh(devices8, hosts=2),
                               event_log=jev.append,
                               config=JJobConfig(adaptive="on"))).collect()
    coll = [e for e in _rewrites(ev_on) if e["kind"] == "agg_tree_collapse"]
    jcoll = [e for e in _rewrites(jev) if e["kind"] == "agg_tree_collapse"]
    assert coll and [(e["stage"], e["orphaned"]) for e in coll] == \
        [(e["stage"], e["orphaned"]) for e in jcoll]
    ran_on, ran_off = _stages_run(ev_on), _stages_run(ev_off)
    assert len(ran_on) < len(ran_off) and ran_on == _stages_run(jev)
    assert set(coll[0]["orphaned"]).isdisjoint(ran_on)
    assert _rows(on, ["s", "n"]) == _rows(off, ["s", "n"]) == \
        _rows(jon, ["s", "n"])


def test_e2e_agg_tree_expand_on_a_flat_plan(devices8):
    """A one-level plan (planned with ``hosts=1``, as the service's SQL
    plans are) run adaptively on a (dcn, dp) mesh: the stage feeding the
    global merge measures more rows than ``adapt_agg_expand_rows``, so
    the tree expands into a ``dp`` hop and an appended ``dcn`` hop, as
    the JAX package's does on its mesh; the tables equal the
    adaptive-off run's and the JAX package's."""
    from dryad_tpu.exec.data import pdata_to_host as jpdata_to_host
    from dryad_tpu.plan.planner import plan_query as jplan_query
    from dryad_tpu.utils.config import JobConfig as JJobConfig
    from dryad_tpu_torch.exec.data import pdata_to_host
    from dryad_tpu_torch.plan.planner import plan_query
    rng = np.random.default_rng(3)
    cols = {"k": rng.integers(0, 300, 6_000).astype(np.int32),
            "v": rng.integers(0, 50, 6_000).astype(np.int32)}

    def run(ctx, planner, to_host):
        node = ctx.from_columns(cols).hash_partition(["v"]).group_by(
            ["k"], {"s": ("sum", "v"), "n": ("count", None)}).node
        return to_host(ctx.executor.run(planner(node, 8)))
    ev, jev = [], []
    on = Context(mesh=_mesh2(), event_log=ev.append, config=JobConfig(
        adaptive="on", adapt_agg_expand_rows=1_000))
    got = run(on, plan_query, pdata_to_host)
    off = run(Context(mesh=_mesh2()), plan_query, pdata_to_host)
    jon = JContext(mesh=jmake_mesh(devices8, hosts=2), event_log=jev.append,
                   config=JJobConfig(adaptive="on",
                                     adapt_agg_expand_rows=1_000))
    jgot = run(jon, jplan_query, jpdata_to_host)
    exp = [e for e in _rewrites(ev) if e["kind"] == "agg_tree_expand"]
    jexp = [e for e in _rewrites(jev) if e["kind"] == "agg_tree_expand"]
    assert exp and [(e["stage"], e["levels_after"]) for e in exp] == \
        [(e["stage"], e["levels_after"]) for e in jexp] == [(1, 2)]
    assert [e["label"] for e in on.executor.stage_log][-1] == \
        "groupby-dcn"
    assert _rows(got) == _rows(off) == _rows(jgot)


# ---------------------------------------------------------------------------
# the gang: (dcn, dp), dcn the process boundary


@pytest.fixture(scope="module")
def cluster():
    from dryad_tpu_torch.runtime import LocalCluster
    old = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["PYTHONPATH"] = HERE + os.pathsep + (old["PYTHONPATH"] or "")
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, HERE)
    cl = LocalCluster(n_processes=2, devices_per_process=4,
                      fn_modules=("torch_cluster_fns",), device="cpu")
    yield cl
    cl.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


LOG_KEYS = ("label", "attempts", "scale", "slack", "salted", "slot_rows",
            "slot_source", "recv_rows")


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _group_query(ctx, n=6_000):
    rng = np.random.default_rng(7)
    k = rng.integers(0, 700, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    return ctx.from_columns({"k": k, "v": v}).group_by(
        ["k"], {"n": ("count", None), "s": ("sum", "v"),
                "m": ("mean", "v")}), k, v


@pytest.mark.parametrize("probe_mb", [8.0, 0.0], ids=["slack", "probe"])
def test_gang_plans_jax_levels_and_equals_the_2d_run(cluster, devices8,
                                                     probe_mb):
    """A gang of two processes plans the JAX package's levels
    ``("dp", "dcn")``: every worker's stage log equals the in-process
    run's on ``make_mesh(..., hosts=2)`` (each hop's received rows per
    partition and its send slots too; with ``exchange_probe_min_mb=0``
    the ``dcn`` hop's slot is probed), the ``dp`` hop staged no byte
    across the processes, and the table equals that run's row for row
    and the JAX package's within the stated bound.  (The two cases
    differ in size: a worker's executor keeps the slots an earlier job
    of the same stage measured.)"""
    cfg = JobConfig(exchange_probe_min_mb=probe_mb)
    n = 6_000 if probe_mb else 6_400
    g = Context(cluster=cluster, config=cfg)
    assert (g.hosts, g.levels) == (2, ("dp", "dcn"))
    gq, k, v = _group_query(g, n)
    local = Context(mesh=_mesh2(), config=cfg)
    lq = _group_query(local, n)[0]
    jq = _group_query(_jctx(hosts=2), n)[0]
    assert gq.explain() == lq.explain() == jq.explain()
    reply = g._cluster_run(gq.node, want_reply=True)
    want = lq.collect()
    _same(reply["table"], want)
    _check_groups(reply["table"], k, v, jq.collect())
    log = [{f: e[f] for f in LOG_KEYS} for e in local.executor.stage_log]
    assert [e["label"] for e in log] == ["groupby-dp", "groupby-dcn"]
    assert log[1]["slot_source"] == [["probe" if probe_mb == 0 else
                                      "slack"]]
    assert [e["staged_bytes"] for e in local.executor.stage_log] == [[0],
                                                                     [0]]
    assert sorted(reply["workers"]) == [0, 1]
    for w, info in reply["workers"].items():
        assert [{f: e[f] for f in LOG_KEYS}
                for e in info["stage_log"]] == log, w
        # the dp hop stays inside each worker: no byte crossed gloo
        dp, dcn = (e["staged_bytes"] for e in info["stage_log"])
        assert dp == [0] and len(dcn) == 1 and dcn[0] > 0, w


def test_gang_adaptive_collapse_equals_in_process_and_jax(cluster,
                                                         devices8):
    """``adaptive="on"`` on the gang: every worker sees the same
    per-partition rows, so every worker collapses the same aggregation
    tree (the same ``graph_rewrites``, the same stages run) as the
    in-process run on the 2-D mesh; the table equals that run's, the
    gang's adaptive-off run's and the JAX package's."""
    from dryad_tpu.utils.config import JobConfig as JJobConfig
    on = Context(cluster=cluster, config=JobConfig(adaptive="on"))
    reply = on._cluster_run(_two_groups(on).node, want_reply=True)
    ev = []
    local = Context(mesh=_mesh2(), event_log=ev.append,
                    config=JobConfig(adaptive="on"))
    lt = _two_groups(local).collect()
    n_rw = len(_rewrites(ev))
    assert n_rw and any(e["kind"] == "agg_tree_collapse"
                        for e in _rewrites(ev))
    logs = []
    for w, info in sorted(reply["workers"].items()):
        assert info.get("graph_rewrites") == n_rw, w
        logs.append([{f: e[f] for f in LOG_KEYS} for e in info["stage_log"]])
    assert logs[0] == logs[1] == [{f: e[f] for f in LOG_KEYS}
                                  for e in local.executor.stage_log]
    _same(reply["table"], lt)
    off = Context(cluster=cluster)
    assert _rows(reply["table"]) == _rows(_two_groups(off).collect())
    jt = _two_groups(JContext(mesh=jmake_mesh(devices8, hosts=2),
                              config=JJobConfig(adaptive="on"))).collect()
    assert _rows(reply["table"], ["s", "n"]) == _rows(jt, ["s", "n"])
