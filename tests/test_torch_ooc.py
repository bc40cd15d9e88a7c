"""The port's out-of-core engine (``dryad_tpu_torch/exec/ooc.py``) against
the JAX package's (``dryad_tpu/exec/ooc.py``), both on the CPU, on the
same numpy inputs made from a seed.

Chunks, sampled bounds, sorted keys and integer results are compared
bit-exact; the rows of a sort as a multiset besides (equal keys may come
in another order); f32 group sums within PERF.md §2's group bound
(1e-5 relative to the sum of |values| of the group, the port's
compensated scan against the JAX package's sum).  Each JAX reference is
computed once per module."""

import collections
import functools
import threading
import time

import numpy as np
import pytest
import torch

from dryad_tpu.exec import autotune as jautotune
from dryad_tpu.exec import ooc as jooc
from dryad_tpu.apps import terasort as jterasort
from dryad_tpu_torch.apps import terasort as tterasort
from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.exec import autotune as tautotune
from dryad_tpu_torch.exec import ooc
from dryad_tpu_torch.ops import kernels as tkernels
from dryad_tpu_torch.plan.expr import Decomposable
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"



def _cat(mod, chunks, schema):
    return mod._concat_hchunks(schema, list(chunks))


def _strs(col):
    data, lens = col
    return [bytes(data[i, : lens[i]]) for i in range(len(lens))]


def _rows(chunk, names=None):
    names = sorted(names or chunk.cols)
    cols = [(_strs(chunk.cols[k]) if isinstance(chunk.cols[k], tuple)
             else chunk.cols[k].tolist()) for k in names]
    return collections.Counter(zip(*cols))


def _same_chunk(a, b):
    assert a.n == b.n and sorted(a.cols) == sorted(b.cols)
    for k, v in a.cols.items():
        w = b.cols[k]
        if isinstance(v, tuple):
            np.testing.assert_array_equal(v[0], w[0])
            np.testing.assert_array_equal(v[1], w[1])
        else:
            assert v.dtype == w.dtype
            np.testing.assert_array_equal(v, w)


def _table(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(-1000, 1000, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32),
            "s": ["w%d" % i for i in rng.randint(0, 5000, n)]}


# ---------------------------------------------------------------------------
# chunk sources


def _sources(mod, tmp, data, store_path, text_path):
    def gen(i):
        return {k: (v[i * 100:(i + 1) * 100]) for k, v in data.items()}
    return {
        "arrays": mod.ChunkSource.from_arrays(data, 128, str_max_len=8),
        "store": mod.ChunkSource.from_store(store_path, 96),
        "text": mod.ChunkSource.from_text([text_path], 70,
                                          max_line_len=12),
        "generator": mod.ChunkSource.from_generator(gen, 7, 64,
                                                    str_max_len=8),
    }


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sources")
    data = _table(700, seed=1)
    text = tmp / "lines.txt"
    # CRLF lines, an empty line, a line past max_line_len, and a last
    # line with no newline
    text.write_bytes(b"".join(
        b"line %d %s\r\n" % (i, b"x" * (i % 17)) if i % 50 else b"\n"
        for i in range(433)) + b"tail-without-newline")
    store = str(tmp / "store")
    jooc.write_chunks_to_store(store, iter(jooc.ChunkSource.from_arrays(
        data, 150, str_max_len=8)), jooc.ChunkSource.from_arrays(
            data, 150, str_max_len=8).schema)
    return (_sources(jooc, tmp, data, store, str(text)),
            _sources(ooc, tmp, data, store, str(text)))


@pytest.mark.parametrize("kind", ["arrays", "store", "text", "generator"])
def test_chunk_sources_equal_jax(sources, kind):
    """Each constructor gives the JAX package's chunks, chunk for chunk,
    twice (a source is re-iterable); the store-backed and text ones carry
    the same kind of fingerprint."""
    jsrc, tsrc = sources[0][kind], sources[1][kind]
    assert tsrc.schema == jsrc.schema and tsrc.chunk_rows == jsrc.chunk_rows
    for _ in range(2):
        jc, tc = list(jsrc), list(tsrc)
        assert len(jc) == len(tc) > 1
        for a, b in zip(jc, tc):
            _same_chunk(a, b)
    assert (tsrc.fingerprint is None) == (jsrc.fingerprint is None)


def test_stores_cross_between_packages(tmp_path):
    """write_chunks_to_store in each package, read by the other's
    from_store: equal chunks; the part files are byte-identical."""
    data = _table(500, seed=2)
    jsrc = jooc.ChunkSource.from_arrays(data, 64, str_max_len=8)
    tsrc = ooc.ChunkSource.from_arrays(data, 64, str_max_len=8)
    jmeta = jooc.write_chunks_to_store(str(tmp_path / "j"), iter(jsrc),
                                       jsrc.schema, compression="gzip")
    tmeta = ooc.write_chunks_to_store(str(tmp_path / "t"), iter(tsrc),
                                      tsrc.schema, compression="gzip")
    assert tmeta["checksums"] == jmeta["checksums"]
    assert tmeta["counts"] == jmeta["counts"]
    for p in range(len(tmeta["counts"])):
        name = f"part-{p:05d}.bin"
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
    for a, b in zip(ooc.ChunkSource.from_store(str(tmp_path / "j"), 100),
                    jooc.ChunkSource.from_store(str(tmp_path / "t"), 100)):
        _same_chunk(a, b)
    # the remote stores (ROADMAP Queue 1 item 10.4): a chunk stream
    # written to hdfs:// (on the loopback fake) streams back in both
    # packages; s3:// refuses a streamed write in both
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from webhdfs_fake import FakeWebHdfs
    hdfs = FakeWebHdfs()
    try:
        ooc.write_chunks_to_store(hdfs.url + "/x", iter(tsrc), tsrc.schema)
        for a, b in zip(ooc.ChunkSource.from_store(hdfs.url + "/x", 100),
                        jooc.ChunkSource.from_store(hdfs.url + "/x", 100)):
            _same_chunk(a, b)
    finally:
        hdfs.close()
    with pytest.raises(ooc.OOCError, match="s3://"):
        ooc.write_chunks_to_store("s3://bucket/x", iter(tsrc), tsrc.schema)


def test_store_corruption_raises(tmp_path):
    data = _table(300, seed=3)
    src = ooc.ChunkSource.from_arrays(data, 100, str_max_len=8)
    ooc.write_chunks_to_store(str(tmp_path / "s"), iter(src), src.schema)
    part = tmp_path / "s" / "part-00001.bin"
    raw = bytearray(part.read_bytes())
    raw[5] ^= 0xFF
    part.write_bytes(bytes(raw))
    it = iter(ooc.ChunkSource.from_store(str(tmp_path / "s"), 50))
    assert next(it).n == 50 and next(it).n == 50
    with pytest.raises(Exception, match="partition 1"):
        next(it)


# ---------------------------------------------------------------------------
# prefetch


def test_prefetch_iter_order_close_and_exception():
    """Order kept; closing the consumer early stops the producer thread
    promptly; a producer exception is raised in the consumer; depth 0 is
    the synchronous iterator (no thread)."""
    made = []

    def gen(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise ValueError("producer failed at %d" % i)
            made.append(i)
            yield ooc.HChunk({"v": np.full(3, i, np.int32)}, 3)

    stats = ooc.PrefetchStats()
    got = [int(c.cols["v"][0]) for c in ooc.prefetch_iter(gen(20), 2,
                                                          stats)]
    assert got == list(range(20)) and stats.snapshot()["chunks"] == 20

    before = threading.active_count()
    made.clear()
    it = ooc.prefetch_iter(gen(10_000), 2)
    assert int(next(it).cols["v"][0]) == 0
    it.close()
    time.sleep(0.3)
    assert len(made) < 10 and threading.active_count() <= before

    with pytest.raises(ValueError, match="failed at 5"):
        list(ooc.prefetch_iter(gen(10, fail_at=5), 3))
    with pytest.raises(ValueError, match="failed at 2"):
        list(ooc.prefetch_iter(gen(10, fail_at=2), 0))


def test_prefetch_shared_stats_under_thread_switching():
    """Twelve consumers (more than the cores) each drain a prefetched
    stream of 300 chunks into ONE PrefetchStats with the interpreter
    switching threads every microsecond: every stream keeps its order
    and the shared counter loses no chunk."""
    import sys
    stats = ooc.PrefetchStats()
    orders = [None] * 12

    def consume(w):
        src = (ooc.HChunk({"v": np.full(1, i, np.int32)}, 1)
               for i in range(300))
        orders[w] = [int(c.cols["v"][0])
                     for c in ooc.prefetch_iter(src, 2, stats)]

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=consume, args=(w,))
              for w in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts)
    assert all(o == list(range(300)) for o in orders)
    assert stats.snapshot()["chunks"] == 12 * 300


def test_stream_map_filter_equals_jax():
    n, chunk = 3_000, 512
    v = np.random.RandomState(0).randn(n).astype(np.float32)
    src = ooc.ChunkSource.from_arrays({"v": v}, chunk)

    def fn(b):
        b = tkernels.filter_rows(b, lambda c: c["v"] > 0)
        return b.with_columns({"w": b.columns["v"] * 2})

    out = _cat(ooc, ooc.stream_map(src, fn, device=CPU),
               {"v": {"kind": "dense", "dtype": "float32", "shape": []},
                "w": {"kind": "dense", "dtype": "float32", "shape": []}})
    np.testing.assert_array_equal(out.cols["v"], v[v > 0])
    np.testing.assert_array_equal(out.cols["w"], v[v > 0] * 2)


# ---------------------------------------------------------------------------
# the host sort-lane mirror against the port's device lanes


def _dense_cases():
    rng = np.random.RandomState(7)
    f = rng.randn(64).astype(np.float32) * 1e3
    f[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    return {
        "int8": rng.randint(-128, 128, 64).astype(np.int8),
        "int16": rng.randint(-2**15, 2**15, 64).astype(np.int16),
        "int32": rng.randint(-2**31, 2**31, 64).astype(np.int32),
        "int64": rng.randint(-2**62, 2**62, 64).astype(np.int64),
        "uint8": rng.randint(0, 256, 64).astype(np.uint8),
        "uint16": rng.randint(0, 2**16, 64).astype(np.uint16),
        "bool": rng.rand(64) < 0.5,
        "float32": f,
        "float64": f.astype(np.float64) * 1.0000001,
    }


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("dtype", sorted(_dense_cases()))
def test_host_lanes_equal_device_lanes_dense(dtype, desc):
    col = _dense_cases()[dtype]
    host = ooc._host_sort_lanes({"kind": "dense", "dtype": dtype}, col, desc)
    dev = tkernels.sort_lanes_for(torch.from_numpy(col), desc)
    assert len(host) == len(dev)
    for h, d in zip(host, dev):
        assert h.dtype == np.uint32
        np.testing.assert_array_equal(h.astype(np.int64), d.numpy())


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 7, 8, 10, 11, 12, 13])
def test_host_lanes_equal_device_lanes_strings(L, desc):
    rng = np.random.RandomState(L)
    lens = rng.randint(0, L + 1, 50).astype(np.int32)
    data = rng.randint(0, 256, (50, L)).astype(np.uint8)
    host = ooc._host_sort_lanes({"kind": "str", "max_len": L},
                                (data, lens), desc)
    dev = tkernels.sort_lanes_for(StringColumn(torch.from_numpy(data),
                                               torch.from_numpy(lens)),
                                  desc)
    assert len(host) == len(dev)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h.astype(np.int64), d.numpy())


# ---------------------------------------------------------------------------
# external sort


def _sort_cases():
    rng = np.random.RandomState(11)
    n = 3_000
    skew = np.where(rng.rand(n) < 0.6, 42,
                    rng.randint(0, 10**6, n)).astype(np.int32)
    words = ["".join(chr(rng.randint(97, 123))
                     for _ in range(rng.randint(0, 8))) for _ in range(n)]
    f = (rng.randn(n) * 100).astype(np.float32)
    f[:4] = [-0.0, 0.0, np.inf, -np.inf]
    return {
        # (columns, keys, chunk_rows, str_max_len, options)
        "int_asc": ({"k": rng.randint(-10**6, 10**6, n).astype(np.int32),
                     "pay": np.arange(n, dtype=np.int32)},
                    [("k", False)], 256, 8, {}),
        "int_desc_multi": ({"a": rng.randint(0, 7, n).astype(np.int32),
                            "b": rng.randint(-50, 50, n).astype(np.int32)},
                           [("a", True), ("b", False)], 256, 8, {}),
        "strings_odd": ({"s": words, "i": np.arange(n, dtype=np.int32)},
                        [("s", False)], 300, 7, {}),
        "float_neg_desc": ({"f": f, "i": np.arange(n, dtype=np.int32)},
                           [("f", True)], 256, 8, {}),
        "skewed": ({"k": skew, "i": np.arange(n, dtype=np.int32)},
                   [("k", False)], 256, 8, {}),
        # two buckets of ~1,500 rows each: both re-bucket
        "rebucket": ({"k": rng.randint(0, 10**6, n).astype(np.int32),
                      "i": np.arange(n, dtype=np.int32)},
                     [("k", False)], 256, 8, {"n_buckets": 2}),
        "constant_host_merge": ({"k": np.full(n, 5, np.int32),
                                 "i": rng.randint(0, 99, n).astype(
                                     np.int32)},
                                [("k", False), ("i", True)], 256, 8, {}),
        "incore": ({"k": rng.randint(0, 10**6, n).astype(np.int32)},
                   [("k", False)], 256, 8, {"incore_bytes": 1 << 20}),
        "spill": ({"k": rng.randint(0, 10**6, n).astype(np.int32),
                   "s": words}, [("k", True)], 256, 8, {"spill": True}),
    }


def _run_sort(mod, case, tmp, **dev):
    cols, keys, chunk, sml, opt = case
    src = mod.ChunkSource.from_arrays(cols, chunk, str_max_len=sml)
    spill = str(tmp / ("spill-" + mod.__name__)) if opt.get("spill") \
        else None
    out = _cat(mod, mod.external_sort(src, keys, spill_dir=spill,
                                      n_buckets=opt.get("n_buckets"),
                                      incore_bytes=opt.get("incore_bytes",
                                                           0), **dev),
               src.schema)
    samples, total = mod._collect_samples(src, keys[0][0])
    nb = max(2, -(-total // chunk) * 2)
    return out, mod._bounds_from_samples(samples, nb)


@pytest.fixture(scope="module")
def jax_sorts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jsort")
    return {name: _run_sort(jooc, case, tmp)
            for name, case in _sort_cases().items()}


@pytest.mark.parametrize("case", sorted(_sort_cases()))
def test_external_sort_equals_jax(jax_sorts, case, tmp_path):
    """Same sampled bounds (bit for bit), the same key sequence, the same
    rows; keys sorted as numpy (lexsort of the host lanes)."""
    jout, jbounds = jax_sorts[case]
    info = {}
    tout, tbounds = _run_sort(ooc, _sort_cases()[case], tmp_path,
                              device=CPU, info=info)
    np.testing.assert_array_equal(tbounds, jbounds)
    keys = _sort_cases()[case][1]
    assert tout.n == jout.n == len(next(iter(_sort_cases()[case][0]
                                             .values())))
    for name, _ in keys:
        tv, jv = tout.cols[name], jout.cols[name]
        if isinstance(tv, tuple):
            assert _strs(tv) == _strs(jv)
        else:
            np.testing.assert_array_equal(tv.view(np.uint8),
                                          jv.view(np.uint8))
    assert _rows(tout) == _rows(jout)
    order = ooc._host_sort_order(ooc.chunk_schema(tout), tout, keys)
    np.testing.assert_array_equal(order, np.arange(tout.n))
    if case == "incore":
        assert info["incore"] and info["scattered"] == 0
    else:
        assert info["scattered"] == -(-tout.n // _sort_cases()[case][2])
    assert (info["rebucketed"] > 0) == (case == "rebucket")


def test_external_sort_scatter_uses_hist_buckets(monkeypatch):
    """Pass B calls hist_buckets once per chunk (B = 2 x chunks), each at
    [chunk_rows] ids, and nothing routes around it."""
    from dryad_tpu_torch.ops import hopper_kernels as hk
    calls = []
    real = hk.hist_buckets

    def spy(bid, nb):
        calls.append((tuple(bid.shape), nb))
        return real(bid, nb)
    monkeypatch.setattr(hk, "hist_buckets", spy)
    k = np.random.RandomState(0).randint(0, 10**6, 2_000).astype(np.int32)
    src = ooc.ChunkSource.from_arrays({"k": k}, 256)
    out = _cat(ooc, ooc.external_sort(src, [("k", False)], device=CPU),
               src.schema)
    np.testing.assert_array_equal(out.cols["k"], np.sort(k))
    assert calls == [((256,), 16)] * 8


def test_terasort_ooc_equals_jax(tmp_path):
    """The app at test_terasort_ooc_oracle's size (20,000 records in
    1,024-record chunks, seed 3): the same store (counts, checksums) in
    both packages, the keys those of ``gen_records`` sorted."""
    jm = jterasort.terasort_ooc(20_000, 1_024, out_store=str(tmp_path / "j"),
                                seed=3)
    info = {}
    tm = tterasort.terasort_ooc(20_000, 1_024, out_store=str(tmp_path / "t"),
                                seed=3, device=CPU, info=info)
    assert tm["counts"] == jm["counts"] and sum(tm["counts"]) == 20_000
    assert tm["checksums"] == jm["checksums"]
    assert tm["partitioning"] == {"kind": "range", "keys": ["key"]}
    src = ooc.ChunkSource.from_store(str(tmp_path / "t"), 20_000)
    got = _strs(_cat(ooc, src, src.schema).cols["key"])
    want = [k for i in range(20) for k in tterasort.gen_records(
        min(1_024, 20_000 - i * 1_024), seed=3 * 1_000_003 + i)["key"]]
    assert got == sorted(want)
    assert info["scattered"] == 20 and info["n_buckets"] == 40


# ---------------------------------------------------------------------------
# streamed reductions


def _red_data():
    rng = np.random.RandomState(13)
    n = 6_000
    return {"k": rng.randint(0, 300, n).astype(np.int32),
            "v": rng.randint(-100, 100, n).astype(np.int32),
            "f": rng.randn(n).astype(np.float32),
            "s": ["g%d" % i for i in rng.randint(0, 40, n)]}


def _j_sumsq():
    import jax.numpy as jnp
    from dryad_tpu.plan.expr import Decomposable as JDec
    return JDec(lambda c: c["v"] * c["v"], lambda a, b: a + b,
                lambda s: s.astype(jnp.float32) + 0.5)


def _t_sumsq():
    return Decomposable(lambda c: c["v"] * c["v"], lambda a, b: a + b,
                        lambda s: s.to(torch.float32) + 0.5)


def _reductions(mod, sumsq, **dev):
    data = _red_data()
    src = mod.ChunkSource.from_arrays(data, 700, str_max_len=8)
    aggs = {"n": ("count", None), "s": ("sum", "v"), "mx": ("max", "v"),
            "fs": ("sum", "f"), "fm": ("mean", "f")}
    out = {
        "group": _concat_frags(mod, mod.streaming_group_aggregate(
            src, ["k"], aggs, n_buckets=8, **dev)),
        "group_str": _concat_frags(mod, mod.streaming_group_aggregate(
            src, ["s"], {"n": ("count", None)}, n_buckets=5, **dev)),
        "topk": _concat_frags(mod, mod.streaming_group_topk(
            src, ["s"], 3, "v", True, n_buckets=4, **dev)),
        "distinct": _concat_frags(mod, mod.streaming_distinct(
            src, ["s"], n_buckets=4, **dev)),
        "distinct_all": _concat_frags(mod, mod.streaming_distinct(
            mod.ChunkSource.from_arrays({"k": data["k"] % 50,
                                         "s": data["s"]}, 700,
                                        str_max_len=8),
            (), n_buckets=4, **dev)),
        "dgroup": _concat_frags(mod, mod.streaming_group_decomposable(
            src, ["k"], {"q": sumsq}, n_buckets=8, **dev)),
    }
    return out


def _concat_frags(mod, chunks):
    chunks = [c for c in chunks]
    return mod._concat_hchunks(mod.chunk_schema(chunks[0]), chunks)


@pytest.fixture(scope="module")
def jax_reductions():
    return _reductions(jooc, _j_sumsq())


def _f32_bound(data, key, col, keys_out):
    """Per group: 1e-5 x sum |values| (PERF.md §2's group bound)."""
    absum = collections.defaultdict(float)
    for k, v in zip(data[key].tolist(), np.abs(data[col]).tolist()):
        absum[k] += v
    return np.asarray([absum[k] for k in keys_out.tolist()]) * 1e-5 + 1e-6


def test_streaming_reductions_equal_jax(jax_reductions):
    """Every streamed reduction: the group-by (count / int sum / max
    exactly, f32 sum and mean within the group bound), a string-keyed
    group-by, per-group top-k, distinct by key and by all columns, and a
    user Decomposable (exactly: int states)."""
    t = _reductions(ooc, _t_sumsq(), device=CPU)
    j = jax_reductions
    data = _red_data()
    for name in ("group_str", "topk", "distinct", "distinct_all",
                 "dgroup"):
        assert _rows(t[name]) == _rows(j[name]), name
    tg, jg = t["group"], j["group"]
    assert _rows(tg, ["k", "n", "s", "mx"]) == _rows(jg, ["k", "n", "s",
                                                          "mx"])
    ti, ji = np.argsort(tg.cols["k"]), np.argsort(jg.cols["k"])
    bound = _f32_bound(data, "k", "f", tg.cols["k"][ti])
    for c in ("fs", "fm"):
        err = np.abs(tg.cols[c][ti].astype(np.float64)
                     - jg.cols[c][ji].astype(np.float64))
        assert (err <= bound).all(), c
    exp = collections.Counter(data["k"].tolist())
    assert dict(zip(tg.cols["k"].tolist(), tg.cols["n"].tolist())) == exp


def test_streaming_group_overflow_raises_like_jax():
    """More distinct keys per bucket than a chunk holds: both packages
    refuse with the same error."""
    k = np.arange(4_000, dtype=np.int32)
    with pytest.raises(jooc.OOCError, match="raise n_buckets") as je:
        list(jooc.streaming_group_aggregate(
            jooc.ChunkSource.from_arrays({"k": k}, 256), ["k"],
            {"n": ("count", None)}, n_buckets=2))
    with pytest.raises(ooc.OOCError, match="raise n_buckets") as te:
        list(ooc.streaming_group_aggregate(
            ooc.ChunkSource.from_arrays({"k": k}, 256), ["k"],
            {"n": ("count", None)}, n_buckets=2, device=CPU))
    assert str(te.value) == str(je.value)


def test_streaming_group_whole_bucket_bound():
    """group_median over a stream (the whole-group machinery) equals the
    numpy lower median; a bucket over ooc_group_bucket_rows raises."""
    data = _red_data()
    src = ooc.ChunkSource.from_arrays(data, 700, str_max_len=8)

    def med(b):
        return tkernels.group_rank_select(b, ["k"], "v", "median", "m")
    out = _concat_frags(ooc, ooc.streaming_group_whole(
        src, ["k"], med, None, n_buckets=4, device=CPU))
    want = {}
    for key in np.unique(data["k"]):
        vals = np.sort(data["v"][data["k"] == key])
        want[int(key)] = int(vals[(len(vals) - 1) // 2])
    assert dict(zip(out.cols["k"].tolist(), out.cols["m"].tolist())) == want
    with pytest.raises(ooc.OOCError, match="ooc_group_bucket_rows=100"):
        list(ooc.streaming_group_whole(src, ["k"], med, None, n_buckets=4,
                                       max_bucket_rows=100, device=CPU))


# ---------------------------------------------------------------------------
# right_match_mask, pick_chunk_rows


def test_right_match_mask_equals_jax():
    import jax.numpy as jnp
    from dryad_tpu.data.columnar import Batch as JBatch
    from dryad_tpu.data.columnar import StringColumn as JString
    from dryad_tpu.ops import kernels as jkernels
    import jax

    @functools.partial(jax.jit, static_argnums=(2,))
    def jmask(jl, jr, keys):
        return jkernels.right_match_mask(jl, jr, list(keys), list(keys))

    rng = np.random.RandomState(17)
    for trial in range(4):
        nl, nr, cl, cr = 40, 30, 48, 33
        lk = rng.randint(0, 25, cl).astype(np.int32)
        rk = rng.randint(0, 25, cr).astype(np.int32)
        ls = rng.randint(0, 256, (cl, 5)).astype(np.uint8)
        rs = ls[rng.randint(0, cl, cr)] if trial % 2 else \
            rng.randint(0, 256, (cr, 5)).astype(np.uint8)
        ll = np.full(cl, 5, np.int32)
        rl = np.full(cr, 5, np.int32)
        jl = JBatch({"k": jnp.asarray(lk), "s": JString(jnp.asarray(ls),
                                                        jnp.asarray(ll))},
                    jnp.asarray(nl, jnp.int32))
        jr = JBatch({"k": jnp.asarray(rk), "s": JString(jnp.asarray(rs),
                                                        jnp.asarray(rl))},
                    jnp.asarray(nr, jnp.int32))
        tl = Batch({"k": torch.from_numpy(lk),
                    "s": StringColumn(torch.from_numpy(ls),
                                      torch.from_numpy(ll))},
                   torch.tensor(nl, dtype=torch.int32))
        tr = Batch({"k": torch.from_numpy(rk),
                    "s": StringColumn(torch.from_numpy(rs),
                                      torch.from_numpy(rl))},
                   torch.tensor(nr, dtype=torch.int32))
        for keys in (["k"], ["s"], ["k", "s"]):
            want = np.asarray(jmask(jl, jr, tuple(keys)))
            got = tkernels.right_match_mask(tl, tr, keys, keys).numpy()
            np.testing.assert_array_equal(got, want)
            assert got[:nr].any() or keys != ["k"]


def test_pick_chunk_rows_equals_jax():
    """Pure arithmetic: the port's pick equals the JAX one over a grid of
    rates, widths, lanes and targets."""
    for link in (1e6, 3e8, 2.5e10):
        for floor in (1e-6, 2e-5, 1e-3, 0.1):
            for rb in (1, 14, 36, 260, 4096):
                for lanes in (None, 1, 5, 70):
                    for eff in (0.5, 0.85, 0.99):
                        kw = dict(rates=(link, floor), row_lanes=lanes,
                                  target_efficiency=eff)
                        assert tautotune.pick_chunk_rows(rb, **kw) == \
                            jautotune.pick_chunk_rows(rb, **kw)
    link, floor = tautotune.measured_rates(device=CPU)
    assert link > 0 and floor > 0
    assert tautotune.measured_rates(device=CPU) == (link, floor)
