"""Streamed plans on the gang (``runtime/stream_plan.py``) on
``LocalCluster(2, 4, device="cpu")``: the counterparts of the 10 tests of
``tests/test_stream_cluster.py`` and of the 4 cluster tests of
``tests/test_stream_coverage.py``, the parallel ``hdfs://`` output, and
unit tests of the runner's pieces.

A cluster Context plans a streamed query at the gang's P = 8 partitions,
exchanges included, and the two workers run it as chunk waves (each wave
one exchange across the processes over gloo) over their own partitions of
the store.  Each result is held to the port's in-process streamed run
(``Context(device="cpu")``, one logical partition) and to the JAX
package's in-process streamed run over the same seeded numpy inputs:
integers bit-exact, row multisets where the query defines no order, rows
in order where it does (a sort).  The workers resolve their UDFs from
``tests/torch_cluster_fns.py``; the JAX runs use ``tests/cluster_fns.py``
(or a lambda: an in-process run ships nothing)."""

import ast
import collections
import inspect
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cluster_fns as JF  # noqa: E402
import torch_cluster_fns as F  # noqa: E402

from dryad_tpu import Context as JContext  # noqa: E402
from dryad_tpu.utils.config import JobConfig as JJobConfig  # noqa: E402
from dryad_tpu_torch import Context  # noqa: E402
from dryad_tpu_torch.exec import ooc  # noqa: E402
from dryad_tpu_torch.io.store import store_meta  # noqa: E402
from dryad_tpu_torch.runtime import LocalCluster  # noqa: E402
from dryad_tpu_torch.utils.config import JobConfig  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

CHUNK = 256
N = 6000            # about 23 chunks: many waves a job
PR_NODES = JF.PR_NODES


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    keys = ("PYTHONPATH", "OMP_NUM_THREADS", "DRYAD_GANG_PR_NODES",
            "DRYAD_TEST_DIE_MARKER")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["PYTHONPATH"] = HERE + os.pathsep + (old["PYTHONPATH"] or "")
    os.environ["OMP_NUM_THREADS"] = "1"
    # the workers' PageRank node count (torch_cluster_fns.PR_NODES)
    os.environ["DRYAD_GANG_PR_NODES"] = str(PR_NODES)
    os.environ["DRYAD_TEST_DIE_MARKER"] = str(
        tmp_path_factory.mktemp("die") / "died")
    cl = LocalCluster(n_processes=2, devices_per_process=4,
                      fn_modules=("torch_cluster_fns",), device="cpu")
    yield cl
    cl.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(17)
    return {"k": rng.randint(0, 25, N).astype(np.int32),
            "v": rng.randint(-10**6, 10**6, N).astype(np.int32)}


@pytest.fixture(scope="module")
def store(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scluster") / "src")
    Context(device="cpu").from_columns(data).to_store(path)
    return path


def _ctx(cluster, **kw):
    return Context(cluster=cluster,
                   config=JobConfig(ooc_chunk_rows=CHUNK, **kw),
                   fn_table=F.FN_TABLE)


def _local(**kw):
    return Context(device="cpu", config=JobConfig(ooc_chunk_rows=CHUNK,
                                                  **kw))


def _jax(**kw):
    return JContext(config=JJobConfig(ooc_chunk_rows=CHUNK, **kw))


def _rows(t, cols=None):
    cols = cols or sorted(t)
    return [tuple(x if isinstance(x, bytes) else np.asarray(x).item()
                  for x in r)
            for r in zip(*[list(t[c]) for c in cols])]


def _same(a, b, cols=None, ordered=False):
    """Two host tables hold the same rows (as a multiset, or in order)."""
    ra, rb = _rows(a, cols), _rows(b, cols)
    if ordered:
        assert ra == rb
    else:
        assert collections.Counter(ra) == collections.Counter(rb)


def _three(cluster, store, query, jquery=None, cols=None, ordered=False,
           **kw):
    """query(ds) on the gang, in process, and jquery(ds) (default query)
    in the JAX package, each over a streamed read of ``store``: the gang's
    table, held to the other two."""
    got = query(_ctx(cluster, **kw).read_store_stream(
        store, chunk_rows=CHUNK)).collect()
    ref = query(_local(**kw).read_store_stream(
        store, chunk_rows=CHUNK)).collect()
    jref = (jquery or query)(_jax(**kw).read_store_stream(
        store, chunk_rows=CHUNK)).collect()
    _same(got, ref, cols, ordered)
    _same(got, jref, cols, ordered)
    return got


# ---------------------------------------------------------------------------
# tests/test_stream_cluster.py


def test_cluster_stream_sort(cluster, store, data, tmp_path):
    """The streamed TeraSort on the gang: bounds sampled across it, a
    range exchange a wave, each partition's external sort, the parallel
    output (each worker writes its own partitions, rank 0 commits)."""
    ctx = _ctx(cluster)
    out = str(tmp_path / "sorted")
    ctx.read_store_stream(store, chunk_rows=CHUNK).order_by(
        [("v", False)]).to_store(out)
    meta = store_meta(out)
    assert meta["npartitions"] == 8          # one per gang partition
    assert meta["partitioning"] == {"kind": "range", "keys": ["v"]}
    back = Context(device="cpu").from_store(out).collect()
    np.testing.assert_array_equal(back["v"], np.sort(data["v"]))
    _three(cluster, store, lambda d: d.order_by([("v", False)]),
           cols=["v"], ordered=True)


def test_cluster_stream_group_collect(cluster, store, data):
    got = _three(cluster, store, lambda d: d.group_by(
        ["k"], {"s": ("sum", "v"), "n": ("count", None)}))
    k, v = data["k"], data["v"]
    assert dict(zip(got["k"].tolist(), got["s"].tolist())) == {
        int(kk): int(v[k == kk].sum()) for kk in np.unique(k)}
    # the mean: an f32 division, held to numpy
    m = _ctx(cluster).read_store_stream(store, chunk_rows=CHUNK).group_by(
        ["k"], {"m": ("mean", "v")}).collect()
    for kk, mm in zip(m["k"].tolist(), m["m"].tolist()):
        assert abs(mm - float(v[k == kk].mean())) < 0.5


def test_cluster_stream_ops_and_count(cluster, store, data):
    """Chunk-local shipped UDFs compose with the streamed terminals."""
    def q(d, f):
        return d.select(f.double_v).where(f.keep_positive)
    s = q(_ctx(cluster).read_store_stream(store, chunk_rows=CHUNK), F)
    assert s.count() == int((data["v"] * 2 > 0).sum()) == q(
        _local().read_store_stream(store, chunk_rows=CHUNK), F).count()
    got = _three(cluster, store,
                 lambda d: q(d, F).group_by(["k"], {"s": ("sum", "v")}),
                 lambda d: q(d, JF).group_by(["k"], {"s": ("sum", "v")}))
    v2 = data["v"] * 2
    mask = v2 > 0
    assert dict(zip(got["k"].tolist(), got["s"].tolist())) == {
        int(kk): int(v2[mask][data["k"][mask] == kk].sum())
        for kk in np.unique(data["k"][mask])}


def test_cluster_stream_group_to_store(cluster, store, data, tmp_path):
    out = str(tmp_path / "grouped")
    _ctx(cluster).read_store_stream(store, chunk_rows=CHUNK).group_by(
        ["k"], {"s": ("sum", "v")}).to_store(out)
    assert store_meta(out)["partitioning"] == {"kind": "hash",
                                               "keys": ["k"]}
    back = Context(device="cpu").from_store(out).collect()
    ref = _local().read_store_stream(store, chunk_rows=CHUNK).group_by(
        ["k"], {"s": ("sum", "v")}).collect()
    jref = _jax().read_store_stream(store, chunk_rows=CHUNK).group_by(
        ["k"], {"s": ("sum", "v")}).collect()
    _same(back, ref)
    _same(back, jref)


def test_cluster_stream_user_decomposable(cluster, store, data):
    """A user Decomposable rides the waves: seed and merge per chunk,
    the merge compacting buckets between waves, the final reduce per
    bucket (IDecomposable.cs:34 on the gang, streamed)."""
    got = _three(cluster, store,
                 lambda d: d.group_by(["k"], {"s": F.SUM_DEC}),
                 lambda d: d.group_by(["k"], {"s": JF.SUM_DEC}))
    k, v = data["k"], data["v"]
    assert dict(zip(got["k"].tolist(), got["s"].tolist())) == {
        int(kk): int(v[k == kk].sum()) for kk in np.unique(k)}


def test_cluster_stream_wordcount(cluster, tmp_path):
    """Streamed WordCount on the gang: string keys ride the waves, the
    group partials compacted between them."""
    words = ["ant", "bee", "cat", "dog", "elk", "fox"]
    rng = np.random.RandomState(23)
    lines = [" ".join(words[i] for i in rng.randint(0, 6, 5))
             for _ in range(2000)]
    src = str(tmp_path / "lines")
    Context(device="cpu").from_columns(
        {"line": [ln.encode() for ln in lines]}, str_max_len=64
    ).to_store(src)
    got = _three(cluster, src, lambda d: d.split_words(
        "line", out_capacity=CHUNK * 8).group_by(["line"],
                                                 {"n": ("count", None)}))
    exp = collections.Counter(w for ln in lines for w in ln.split())
    assert {w.decode(): int(n) for w, n in zip(got["line"], got["n"])} \
        == dict(exp)


def test_cluster_stream_join(cluster, store, data):
    """A streamed join on the gang: both legs hash-exchanged in waves to
    bucket streams, each partition's stream probing its materialized
    bucket of the build side."""
    dim = {"k": np.arange(0, 25, dtype=np.int32),
           "w": (np.arange(25, dtype=np.int32) * 7).astype(np.int32)}
    ctx = _ctx(cluster)
    got = ctx.read_store_stream(store, chunk_rows=CHUNK).join(
        ctx.from_columns(dim), ["k"], expansion=2.0).collect()
    loc = _local()
    ref = loc.read_store_stream(store, chunk_rows=CHUNK).join(
        loc.from_columns(dim), ["k"], expansion=2.0).collect()
    jx = _jax()
    jref = jx.read_store_stream(store, chunk_rows=CHUNK).join(
        jx.from_columns(dim), ["k"], expansion=2.0).collect()
    _same(got, ref)
    _same(got, jref)
    assert len(got["k"]) == N
    assert (got["w"] == got["k"] * 7).all()


def _pagerank(ctx, estore, f, rank_cap):
    deg = (ctx.read_store_stream(estore, chunk_rows=128)
           .group_by(["src"], {"deg": ("count", None)}).cache())
    nodes = {"node": np.arange(PR_NODES, dtype=np.int32),
             "rank": np.full(PR_NODES, 1.0 / PR_NODES, np.float32)}
    ranks0 = ctx.from_columns(nodes).with_capacity(rank_cap)

    def body(ranks):
        return (ctx.read_store_stream(estore, chunk_rows=128)
                .join(deg, ["src"], ["src"], expansion=2.0)
                .join(ranks, ["src"], ["node"], expansion=2.0)
                .select(f.pr_contrib)
                .group_by(["node"], {"s": ("sum", "c")})
                .select(f.pr_damp)).with_capacity(rank_cap)

    out = ctx.do_while(ranks0, body, n_iters=10).collect()
    got = np.zeros(PR_NODES)
    for n_, r_ in zip(out["node"], out["rank"]):
        got[int(n_)] = float(r_)
    return got


def test_cluster_stream_pagerank_do_while(cluster, tmp_path, monkeypatch):
    """Streamed PageRank, 10 supersteps, on the gang: the edges stream
    from the store every superstep, the out-degrees are a cluster
    re-streaming cache, the ranks stay resident on the workers as the
    loop state; held to the dense numpy oracle and to both in-process
    streamed runs."""
    from dryad_tpu_torch.apps import pagerank
    edges = pagerank.gen_graph(PR_NODES, 600, seed=3)
    estore = str(tmp_path / "edges")
    Context(device="cpu").from_columns(edges).to_store(estore)
    # the driver's own copy of the UDF module reads the node count too
    monkeypatch.setattr(F, "PR_NODES", PR_NODES)
    rank_cap = min(PR_NODES, 4 * (-(-PR_NODES // 8)) + 8)
    got = _pagerank(_ctx(cluster), estore, F, rank_cap)
    ref = _pagerank(_local(), estore, F, rank_cap)
    jref = _pagerank(_jax(), estore, JF, rank_cap)
    exp = pagerank.pagerank_numpy(edges, PR_NODES, n_iters=10)
    np.testing.assert_allclose(got, exp, rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, jref, rtol=1e-5, atol=1e-7)


def test_cluster_stream_worker_death_replays(cluster, store, data,
                                             tmp_path):
    """A worker that dies in the middle of a streamed job's waves (worker
    1 exits the first time ``die_once`` runs there) is detected, the gang
    restarts, and the driver replays the streamed query to its end
    (lineage replay over the streamed path)."""
    marker = os.environ["DRYAD_TEST_DIE_MARKER"]
    assert not os.path.exists(marker)
    ctx = _ctx(cluster)
    out = str(tmp_path / "sorted-chaos")
    (ctx.read_store_stream(store, chunk_rows=CHUNK).select(F.die_once)
     .order_by([("v", False)]).to_store(out))
    assert os.path.exists(marker)            # the worker did die
    assert sum(store_meta(out)["counts"]) == N
    back = Context(device="cpu").from_store(out).collect()
    np.testing.assert_array_equal(back["v"], np.sort(data["v"]))


def test_cluster_from_stream_spool_and_whole_group(cluster, tmp_path):
    """``from_stream`` on a cluster Context: the driver spools its
    generator into a store under ``cluster_stream_spool_dir`` and the
    gang streams it through the planned surface — here the whole-group
    ``group_median``, which materializes complete key buckets per
    partition after the exchange."""
    rng = np.random.RandomState(9)
    n = 4000
    k = rng.randint(0, 20, n).astype(np.int32)
    v = rng.randint(0, 1000, n).astype(np.int32)

    def gen(i):
        lo, hi = i * CHUNK, min((i + 1) * CHUNK, n)
        return {"k": k[lo:hi], "v": v[lo:hi]}

    spool = tmp_path / "spool"
    ctx = _ctx(cluster, cluster_stream_spool_dir=str(spool))
    cs = ooc.ChunkSource.from_generator(gen, -(-n // CHUNK), CHUNK)
    got = ctx.from_stream(cs).group_median(["k"], "v", out="med").collect()
    assert len(os.listdir(spool)) == 1       # one spooled store
    ref = _local().from_stream(ooc.ChunkSource.from_generator(
        gen, -(-n // CHUNK), CHUNK)).group_median(
        ["k"], "v", out="med").collect()
    jref = JContext().from_columns({"k": k, "v": v}).group_median(
        ["k"], "v", out="med").collect()
    _same(got, ref)
    _same(got, jref)
    assert len(got["k"]) == 20


def test_cluster_stream_wave_columns_in_any_order(cluster, tmp_path):
    """A store whose schema lists its columns in another order than its
    chunks carry them (``v`` before ``k``; a store part is read back in
    sorted column order), of 20 chunks, so that in the last wave half
    the partitions (all of rank 1) have ended and send empty chunks:
    every wave packs all partitions' columns in one order, and the rows
    come through whole (the same (k, v) pairs) in both exchanges."""
    rng = np.random.RandomState(31)
    n = 20 * CHUNK
    cols = {"v": rng.randint(0, 10**6, n).astype(np.int32),
            "k": rng.randint(0, 40, n).astype(np.int32)}
    src = str(tmp_path / "vk")
    cs = ooc.ChunkSource.from_arrays(cols, CHUNK)
    ooc.write_chunks_to_store(src, iter(cs), cs.schema)
    assert list(store_meta(src)["schema"]) == ["v", "k"]
    want = collections.Counter(zip(cols["k"].tolist(), cols["v"].tolist()))
    got = _three(cluster, src, lambda d: d.hash_partition(["k"]),
                 cols=["k", "v"])
    assert collections.Counter(_rows(got, ["k", "v"])) == want
    srt = _three(cluster, src, lambda d: d.order_by([("v", False)]),
                 cols=["k", "v"], ordered=True)
    assert collections.Counter(_rows(srt, ["k", "v"])) == want


# ---------------------------------------------------------------------------
# tests/test_stream_coverage.py (its cluster block)


def test_cluster_stream_global_take(cluster, store, data):
    """A global take over the gang's streams: after a range-exchanged
    sort the partition-major prefix IS the global top n, in order; an
    unsorted take gives exactly n rows of the data."""
    got = _three(cluster, store,
                 lambda d: d.order_by([("v", True)]).take(23),
                 cols=["k", "v"], ordered=True)
    np.testing.assert_array_equal(got["v"], np.sort(data["v"])[::-1][:23])
    sds = _ctx(cluster).read_store_stream(store, chunk_rows=CHUNK)
    t = sds.take(CHUNK + 13).collect()
    assert len(t["v"]) == CHUNK + 13
    allowed = set(zip(data["k"].tolist(), data["v"].tolist()))
    assert set(zip(t["k"].tolist(), t["v"].tolist())) <= allowed
    assert sds.take(N + 50).count() == N


def test_cluster_stream_zip(cluster, store, data):
    """zip over the gang's streams: both sides come from the SAME store
    (the same partition layout), so per-partition positional pairing is
    global row pairing — every x meets its own 2x.  (The JAX package's
    cluster form of this test ships lambdas and fails at DTA014; its
    in-process streamed run is the reference.)"""
    def q(d, fx, fy):
        return d.select(fx).zip_with(d.select(fy))
    got = q(_ctx(cluster).read_store_stream(store, chunk_rows=CHUNK),
            F.zip_x, F.zip_y).collect()
    ref = q(_local().read_store_stream(store, chunk_rows=CHUNK),
            F.zip_x, F.zip_y).collect()
    jref = q(_jax().read_store_stream(store, chunk_rows=CHUNK),
             lambda c: {"x": c["v"]}, lambda c: {"y": c["v"] * 2}).collect()
    assert len(got["x"]) == N
    np.testing.assert_array_equal(got["y"], got["x"] * 2)
    _same(got, ref)
    _same(got, jref)
    assert sorted(got["x"].tolist()) == sorted(data["v"].tolist())


def test_cluster_stream_group_median(cluster, store, data):
    got = _three(cluster, store,
                 lambda d: d.group_median(["k"], "v", out="med"))
    k, v = data["k"], data["v"]
    assert dict(zip(got["k"].tolist(), got["med"].tolist())) == {
        int(kk): int(np.sort(v[k == kk])[(np.sum(k == kk) - 1) // 2])
        for kk in np.unique(k)}


def test_cluster_stream_group_apply(cluster, store, data):
    def q(f):
        return lambda d: d.group_apply(
            ["k"], f.second_largest, group_capacity=1024, max_groups=64,
            out_rows=1, out_capacity=64)
    got = _three(cluster, store, q(F), q(JF))
    k, v = data["k"], data["v"]
    exp = {}
    for kk in np.unique(k):
        s = np.sort(v[k == kk])[::-1]
        exp[int(kk)] = int(s[1] if len(s) >= 2 else s[0])
    assert dict(zip(got["k"].tolist(), got["second"].tolist())) == exp


# ---------------------------------------------------------------------------
# parallel output to hdfs:// and the s3:// refusal


def test_cluster_stream_parallel_hdfs_output(cluster, store, data):
    """Every worker uploads its own partitions into ``<path>.tmp`` on
    WebHDFS, rank 0 writes the manifest and makes the rename: the store
    reads back (through the port and the JAX package) as the sort."""
    from dryad_tpu_torch.io import webhdfs
    from webhdfs_fake import FakeWebHdfs
    srv = FakeWebHdfs(block_size=4096)
    try:
        url = srv.url + "/out/sorted"
        _ctx(cluster).read_store_stream(store, chunk_rows=CHUNK).order_by(
            [("v", False)]).to_store(url)
        meta = webhdfs.hdfs_store_meta(url)
        assert meta["npartitions"] == 8
        assert sum(meta["counts"]) == N
        assert "/out/sorted.tmp" not in srv.dirs
        parts = sorted(p for p in srv.files if p.startswith("/out/sorted/"))
        assert len(parts) == 9                 # 8 parts and meta.json
        back = Context(device="cpu").from_store(url).collect()
        np.testing.assert_array_equal(back["v"], np.sort(data["v"]))
        jback = JContext().from_store(url).collect()
        np.testing.assert_array_equal(np.asarray(jback["v"]), back["v"])
    finally:
        srv.close()


def test_cluster_stream_s3_output_refused(cluster, store):
    from dryad_tpu_torch.runtime.cluster import ClusterJobError
    with pytest.raises(ClusterJobError, match="s3:// is not supported"):
        _ctx(cluster).read_store_stream(store, chunk_rows=CHUNK).order_by(
            [("v", False)]).to_store("s3://bucket/out")


# ---------------------------------------------------------------------------
# the runner's pieces


def test_global_take_equals_jax():
    """``_global_take`` on one process (the all-gather is the identity)
    against the JAX package's on the same chunks: the partition-major
    prefix, cut at n."""
    from dryad_tpu.exec import ooc as jooc
    from dryad_tpu.runtime import stream_plan as jsp
    from dryad_tpu_torch.parallel.mesh import Mesh
    from dryad_tpu_torch.runtime import stream_plan as tsp

    def mk(mod, vals, chunk=3):
        return mod.ChunkSource.from_arrays(
            {"v": np.asarray(vals, np.int32)}, chunk)

    mesh = Mesh("cpu", 2)
    for n in (0, 2, 9, 12, 99):
        tdev = tsp._DevStreams([mk(ooc, range(0, 7)),
                                mk(ooc, range(100, 105))])
        jdev = jsp._DevStreams([mk(jooc, range(0, 7)),
                                mk(jooc, range(100, 105))])
        got = [[c.cols["v"].tolist() for c in cs]
               for cs in tsp._global_take(tdev, n, mesh).streams]
        want = [[c.cols["v"].tolist() for c in cs]
                for cs in jsp._global_take(jdev, n, None).streams]
        assert got == want, n
    # the result streams stay re-iterable
    cs0 = tsp._global_take(tdev, 9, mesh).streams[0]
    assert sum(c.n for c in cs0) == sum(c.n for c in cs0) == 7


def test_split_local_and_put_wave_equal_jax():
    """``_split_local`` block-splits a host chunk over a rank's
    partitions exactly as the JAX package's does (dense, vector and
    string columns, a remainder, no chunk); ``_put_wave`` places those
    blocks as one zero-padded Batch a partition."""
    from dryad_tpu.exec import ooc as jooc
    from dryad_tpu.runtime import stream_cluster as jsc
    from dryad_tpu_torch.parallel.mesh import Mesh
    from dryad_tpu_torch.runtime import stream_cluster as tsc
    rng = np.random.RandomState(5)
    n = 11
    strs = [bytes(rng.randint(97, 123, rng.randint(0, 7)).astype(np.uint8))
            for _ in range(n)]
    cols = {"v": rng.randint(-9, 9, n).astype(np.int32),
            "w": rng.rand(n, 3).astype(np.float32), "s": strs}
    (tch,) = ooc.ChunkSource.from_arrays(cols, 64, str_max_len=8)
    (jch,) = jooc.ChunkSource.from_arrays(cols, 64, str_max_len=8)
    schema = ooc.chunk_schema(tch)
    for chunk, jchunk in ((tch, jch), (None, None)):
        got, gcounts = tsc._split_local(chunk, schema, 4, 16)
        want, wcounts = jsc._split_local(jchunk, schema, 4, 16)
        np.testing.assert_array_equal(gcounts, wcounts)
        for k in schema:
            pairs = (zip(got[k], want[k]) if isinstance(got[k], tuple)
                     else [(got[k], want[k])])
            for a, b in pairs:
                np.testing.assert_array_equal(a, b)
    parts = tsc._put_wave(tch, schema, 16, Mesh("cpu", 8, rank=1, world=2))
    got, counts = tsc._split_local(tch, schema, 4, 16)
    assert [int(b.count) for b in parts] == counts.tolist() == [3, 3, 3, 2]
    for d, b in enumerate(parts):
        assert b.capacity == 16
        np.testing.assert_array_equal(b.columns["v"].numpy(), got["v"][d])
        np.testing.assert_array_equal(b.columns["s"].data.numpy(),
                                      got["s"][0][d])


SAMPLE_CHUNK = 1024   # 512 of its rows sampled a chunk
SAMPLE_ROWS = 40_000    # about 11,000 samples a rank: past the 8,192 cap


@pytest.fixture(scope="module")
def str_store(tmp_path_factory):
    """A store of 0-10-byte string keys in 11 partitions, more than the
    gang's P = 8: rank 0's first local partition streams store partitions
    0 and 8, and so on."""
    rng = np.random.RandomState(23)
    keys = [bytes(rng.randint(32, 127, rng.randint(0, 11)).astype(np.uint8))
            for _ in range(SAMPLE_ROWS)]
    path = str(tmp_path_factory.mktemp("sstore") / "src")
    Context(device="cpu", nparts=11).from_columns(
        {"key": keys, "v": np.arange(SAMPLE_ROWS, dtype=np.int32)}
    ).to_store(path)
    return path


def _rank_parts(path, world=2, dpp=4):
    """Each rank's local partitions' store partitions (p mod P)."""
    P = world * dpp
    n = store_meta(path)["npartitions"]
    return [[[p for p in range(n) if p % P == r * dpp + d]
             for d in range(dpp)] for r in range(world)]


def _first_lane(col):
    """A key column's first 32-bit sort lane in plain numpy: an int32
    offset by 2**31, or a string's first four bytes big-endian (bytes past
    its length read as 0)."""
    if isinstance(col, tuple):
        data, lens = col
        assert data.shape[1] >= 4
        b = np.where(np.arange(4)[None, :] < lens[:, None], data[:, :4],
                     0).astype(np.uint32)
        return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    return (col.astype(np.int64) + 2**31).astype(np.uint32)


def _numpy_gang_cut(path, key, chunk, world=2, dpp=4, per_chunk=512,
                    cap=8192):
    """The range bounds a gang of world x dpp must cut over ``path``, in
    plain numpy: each store partition (read whole by the JAX package's
    reader) sliced into ``chunk``-row chunks, ``min(rows, per_chunk)``
    evenly spaced rows a chunk, their keys' first sort lane, at most
    ``cap`` evenly spaced samples a local partition and a rank, the ranks
    in order, sorted, and the ``len * (i + 1) // P``-th as bound i."""
    from dryad_tpu.exec import ooc as jooc

    def cut(s):
        if len(s) > cap:
            s = s[np.linspace(0, len(s) - 1, cap).astype(np.int64)]
        return s

    ranks = []
    for local in _rank_parts(path, world, dpp):
        rank = []
        for parts in local:
            s = []
            for whole in jooc.ChunkSource.from_store(path, 1 << 30,
                                                     partitions=parts):
                col = whole.cols[key]
                for a in range(0, whole.n, chunk):
                    n = min(chunk, whole.n - a)
                    idx = a + np.linspace(0, n - 1, min(n, per_chunk)
                                          ).astype(np.int64)
                    s.append(_first_lane(tuple(c[idx] for c in col)
                                         if isinstance(col, tuple)
                                         else col[idx]))
            rank.append(cut(np.concatenate(s) if s
                            else np.zeros((0,), np.uint32)))
        ranks.append(cut(np.concatenate(rank)))
    s = np.sort(np.concatenate(ranks).astype(np.uint64))
    P = world * dpp
    return np.asarray([s[min(len(s) * (i + 1) // P, len(s) - 1)]
                       for i in range(P - 1)], np.uint32)


@pytest.mark.parametrize("which", ["int", "str"])
def test_sample_pass_equals_jax_on_each_ranks_partitions(store, str_store,
                                                          which):
    """Each local partition's samples: the port's ``_sample_pass`` over
    its store partitions (p mod P) bit-equal to the JAX package's over the
    same partitions, chunk and row counts too; and the cut of one rank's
    samples equal to JAX's ``_gathered_bounds``, which cuts a lone
    process's samples."""
    from dryad_tpu.exec import ooc as jooc
    from dryad_tpu.runtime import stream_cluster as jsc
    from dryad_tpu_torch.parallel.mesh import Mesh
    from dryad_tpu_torch.runtime import stream_cluster as sc
    path, key, chunk = ((store, "v", CHUNK) if which == "int"
                        else (str_store, "key", SAMPLE_CHUNK))
    rows = 0
    for local in _rank_parts(path):
        for parts in local:
            got = sc._sample_pass(ooc.ChunkSource.from_store(
                path, chunk, partitions=parts), key)
            want = jsc._sample_pass(jooc.ChunkSource.from_store(
                path, chunk, partitions=parts), key)
            assert got[0].dtype == np.uint32 and len(got[0])
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            rows += got[2]
            np.testing.assert_array_equal(
                sc._gathered_bounds(got[0], Mesh("cpu", 8), 8),
                jsc._gathered_bounds(want[0], None, 8))
    assert rows == (N if which == "int" else SAMPLE_ROWS)


@pytest.mark.parametrize("which", ["int", "str"])
def test_gang_range_bounds_equal_numpy_and_jax(cluster, store, str_store,
                                               monkeypatch, which):
    """The bounds the gang's streamed sort cut (each worker's reply) are
    bit-equal in both workers, to a plain numpy cut straight from the
    store's partitions (``_numpy_gang_cut``), and to the JAX package's
    samples of each rank's partitions merged and capped as a rank merges
    them and cut by its ``_bounds_from_samples``.  The string store
    passes the 8,192-sample cap a rank."""
    from dryad_tpu.exec import ooc as jooc
    from dryad_tpu.runtime import stream_cluster as jsc
    path, key, chunk = ((store, "v", CHUNK) if which == "int"
                        else (str_store, "key", SAMPLE_CHUNK))
    replies, real = [], cluster.execute

    def execute(*a, **kw):
        r = real(*a, **kw)
        replies.append(r)
        return r
    monkeypatch.setattr(cluster, "execute", execute)
    ctx = Context(cluster=cluster, fn_table=F.FN_TABLE,
                  config=JobConfig(ooc_chunk_rows=chunk))
    out = ctx.read_store_stream(path, chunk_rows=chunk).order_by(
        [(key, False)]).collect()
    assert len(out[key]) == (N if which == "int" else SAMPLE_ROWS)
    (reply,) = replies
    bounds = [w["stream"]["bounds"] for w in reply["workers"].values()]
    assert len(bounds) == 2 and bounds[0] == bounds[1]
    (got,) = bounds[0]
    np.testing.assert_array_equal(np.asarray(got, np.uint32),
                                  _numpy_gang_cut(path, key, chunk))
    merged, sampled = [], []
    for local in _rank_parts(path):
        m = np.concatenate([jsc._sample_pass(jooc.ChunkSource.from_store(
            path, chunk, partitions=parts), key)[0] for parts in local])
        sampled.append(len(m))
        if len(m) > jsc._MAX_SAMPLES:
            m = m[np.linspace(0, len(m) - 1, jsc._MAX_SAMPLES).astype(
                np.int64)]
        merged.append(m)
    np.testing.assert_array_equal(
        np.asarray(got, np.uint32),
        jooc._bounds_from_samples(np.concatenate(merged), 8))
    # rank 0 streams 7 of the 11 store partitions
    assert (max(sampled) > jsc._MAX_SAMPLES) == (which == "str")


def test_stream_plan_raise_sites_carry_registered_codes():
    """Every StreamPlanError raise site of the port's stream_plan carries
    a literal ``code=`` that is registered and either mirrored by a
    static rule or runtime-only (the counterpart of
    ``tests/test_analysis.py::test_runtime_raises_match_analyzer_rules``),
    and the JAX package's raise sites carry the same codes."""
    from dryad_tpu.runtime import stream_plan as jsp
    from dryad_tpu_torch.analysis import RULES, STATIC_RULE_CODES
    from dryad_tpu_torch.analysis.diagnostics import (CODES,
                                                      RUNTIME_ONLY_CODES)
    from dryad_tpu_torch.runtime import stream_plan as tsp

    def sites(mod):
        out = []
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if not (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)):
                continue
            f = node.exc.func
            name = f.id if isinstance(f, ast.Name) else getattr(
                f, "attr", "")
            if name != "StreamPlanError":
                continue
            kw = {k.arg: k.value for k in node.exc.keywords}
            assert "code" in kw, f"line {node.lineno}: no code="
            assert isinstance(kw["code"], ast.Constant), node.lineno
            out.append(kw["code"].value)
        return out

    got = sites(tsp)
    assert sorted(set(got)) == ["DTA002", "DTA003", "DTA901", "DTA902",
                                "DTA903", "DTA904"]
    # JAX's two more DTA003 sites read its empty ``_UNSUPPORTED`` table
    assert not jsp._UNSUPPORTED and not hasattr(tsp, "_UNSUPPORTED")
    assert collections.Counter(got) + collections.Counter(
        {"DTA003": 2}) == collections.Counter(sites(jsp))
    rule_codes = {r.code for r in RULES}
    for code in got:
        assert code in CODES
        assert code in STATIC_RULE_CODES or code in RUNTIME_ONLY_CODES
        if code not in RUNTIME_ONLY_CODES:
            assert code in rule_codes


def test_cluster_adaptive_on_still_refuses(cluster, store):
    """``adaptive="on"`` on a gang no longer refuses (the gang's
    stage statistics are gang-wide since the hierarchical aggregation
    came, ``tests/test_torch_mesh.py``).  A streamed plan runs as chunk
    waves, which adapt nothing, in the JAX package as in the port: the
    count equals the adaptive-off one."""
    on = _ctx(cluster, adaptive="on")
    assert on.read_store_stream(store, chunk_rows=CHUNK).count() == \
        _ctx(cluster).read_store_stream(store, chunk_rows=CHUNK).count() \
        > 0
