"""Streamed queries through the port's plain Dataset API
(``dryad_tpu_torch/exec/stream_exec.py``) against the same queries in the
JAX package, both on the CPU, over one store written from a seed (8,000
rows, 512-row chunks: about 16 chunks a pass).

Integer and string columns are compared exactly, as row multisets (or in
order for ordered queries); float columns within 1e-5 relative (the f32
sums of a group, PERF.md §2's group bound, of values below 1e3 in
magnitude).  Each case runs its JAX query in its own test."""

import collections
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dryad_tpu import Context as JContext
from dryad_tpu.plan.expr import Decomposable as JDec
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.exec import ooc
from dryad_tpu_torch.exec.ooc import ChunkSource as TChunkSource
from dryad_tpu_torch.exec.stream_exec import StreamExecutionError
from dryad_tpu_torch.plan.expr import Decomposable as TDec
from tests.torch_threads import one_torch_thread  # noqa: F401

CHUNK = 512
N = 8000



@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    return {"k": rng.randint(0, 40, N).astype(np.int32),
            "v": rng.randint(-1000, 1000, N).astype(np.int32),
            "f": rng.randn(N).astype(np.float32)}


@pytest.fixture(scope="module")
def store(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tstream") / "store")
    TContext(device="cpu", nparts=4).from_columns(data).to_store(path)
    return path


def _knobs(kw):
    return {"ooc_chunk_rows": CHUNK, "ooc_hash_buckets": 32, **kw}


def _jctx(**kw):
    return JContext(config=JJobConfig(**_knobs(kw)))


def _tctx(**kw):
    return TContext(device="cpu", config=JobConfig(**_knobs(kw)))


def _cols(t):
    return {k: (list(v) if isinstance(v, list) else np.asarray(v))
            for k, v in t.items()}


def assert_tables(got, exp, ordered=False, rtol=1e-5):
    """Equal tables: integer / string / bool columns exactly, float
    columns within ``rtol`` (x max(1, |value|)); as row multisets unless
    ``ordered``."""
    got, exp = _cols(got), _cols(exp)
    assert sorted(got) == sorted(exp)
    names = sorted(got)
    n = len(got[names[0]])
    assert all(len(got[k]) == len(exp[k]) == n for k in names)
    fl = [k for k in names if not isinstance(got[k], list)
          and got[k].dtype.kind == "f"]
    ex = [k for k in names if k not in fl]

    def key_rows(t):
        return [tuple((t[k][i] if isinstance(t[k], list)
                       else t[k][i].tolist()) for k in ex)
                + tuple(round(float(np.asarray(t[k][i]).sum()), 2)
                        for k in fl) for i in range(n)]

    gk, ek = key_rows(got), key_rows(exp)
    gi = list(range(n)) if ordered else sorted(range(n),
                                               key=lambda i: gk[i])
    ei = list(range(n)) if ordered else sorted(range(n),
                                               key=lambda i: ek[i])
    assert [gk[i][:len(ex)] for i in gi] == [ek[i][:len(ex)] for i in ei]
    for k in fl:
        g = got[k][np.asarray(gi, np.int64)].astype(np.float64)
        e = exp[k][np.asarray(ei, np.int64)].astype(np.float64)
        assert g.shape == e.shape
        close = np.abs(g - e) <= rtol * np.maximum(1.0, np.abs(e))
        assert np.all(close | (np.isnan(g) & np.isnan(e))), k


# ---------------------------------------------------------------------------
# the sweep: each case is (query(ds, ctx, lib), ordered)


class _Lib:
    """The package-specific pieces a query needs."""

    def __init__(self, jax: bool):
        self.np = jnp if jax else torch
        self.Dec = JDec if jax else TDec

    def maximum(self, a, b):
        return self.np.maximum(a, b)


def _dim(ctx):
    return ctx.from_columns({"k": np.arange(0, 30, dtype=np.int32),
                             "name": np.arange(0, 30, dtype=np.int32) * 100})


def _flat(lib):
    def fn(c):
        x = c["v"]
        out = {"v": lib.np.stack([x, x + 1], 1),
               "k": lib.np.stack([c["k"], c["k"]], 1)}
        return out, lib.np.stack([x > 0, x > 500], 1)
    return fn


def _sel(lib):
    def sel(cols, count):
        m = lib.np.arange(cols["v"].shape[0]) < count
        s = lib.np.where(m, cols["v"], 0).sum()
        return ({"cnt": count.reshape(1).astype(lib.np.int32)
                 if lib.np is jnp else count.reshape(1).to(torch.int32),
                 "sv": s.reshape(1).astype(lib.np.int32)
                 if lib.np is jnp else s.reshape(1).to(torch.int32)},
                lib.np.ones((1,), dtype=bool if lib.np is jnp
                            else torch.bool))
    return sel


CASES = {
    "select_where": (lambda d, c, lib: d.select(
        lambda x: {"k": x["k"], "v": x["v"] * 2}).where(
            lambda x: x["v"] > 0), True),
    "group_by": (lambda d, c, lib: d.group_by(
        ["k"], {"s": ("sum", "v"), "n": ("count", None),
                "m": ("mean", "f"), "lo": ("min", "v"),
                "fs": ("sum", "f")}), False),
    "distinct": (lambda d, c, lib: d.select(
        lambda x: {"k": x["k"]}).distinct(), False),
    "join_inner": (lambda d, c, lib: d.where(lambda x: x["v"] > 500)
                   .join(_dim(c), ["k"], expansion=2.0), False),
    "join_left": (lambda d, c, lib: d.where(lambda x: x["v"] > 500)
                  .join(_dim(c), ["k"], expansion=2.0, how="left"), False),
    "join_right": (lambda d, c, lib: d.where(lambda x: x["v"] > 800)
                   .join(_dim(c), ["k"], expansion=2.0, how="right"),
                   False),
    "join_full": (lambda d, c, lib: d.where(lambda x: x["v"] > 800)
                  .join(_dim(c), ["k"], expansion=2.0, how="full"), False),
    "row_index_concat": (lambda d, c, lib: d.take(100).concat(
        d.skip(N - 50)).with_row_index(), True),
    "tee_fork": (lambda d, c, lib: (lambda p: p[0].concat(p[1]))(
        d.select(lambda x: {"k": x["k"], "v": x["v"] + 1})
        .fork_by(lambda x: x["v"] > 0)), False),
    "group_then_sort": (lambda d, c, lib: d.group_by(
        ["k"], {"s": ("sum", "v")}).order_by([("s", True)]), True),
    "order_by_multi": (lambda d, c, lib: d.order_by(
        [("k", True), ("v", False)]), True),
    "decomposable": (lambda d, c, lib: d.group_by(
        ["k"], {"hi": lib.Dec(lambda x: x["v"], lib.maximum, None)}),
        False),
    "group_top_k": (lambda d, c, lib: d.group_top_k(["k"], 3, "v"), False),
    "group_median": (lambda d, c, lib: d.group_median(["k"], "v",
                                                      out="med"), False),
    # few keys: the JAX package compiles its selector once per bucket
    # size
    "group_apply": (lambda d, c, lib: d.where(
        lambda x: x["k"] < 5).group_apply(
        ["k"], _sel(lib), max_groups=64, group_capacity=512, out_rows=1,
        out_capacity=64), False),
    "take_while": (lambda d, c, lib: d.take_while(
        lambda x: x["v"] > -920), True),
    "skip_while": (lambda d, c, lib: d.skip_while(
        lambda x: x["v"] > -920), True),
    "sliding_window": (lambda d, c, lib: d.take(40).select(
        lambda x: {"v": x["v"]}).sliding_window(7), True),
    "flat_map": (lambda d, c, lib: d.flat_map(_flat(lib), CHUNK), True),
    "with_capacity": (lambda d, c, lib: d.where(
        lambda x: x["v"] > 900).with_capacity(CHUNK // 2), True),
    "intersect": (lambda d, c, lib: d.select(lambda x: {"k": x["k"]})
                  .intersect(c.from_columns({"k": np.arange(
                      20, 60, dtype=np.int32)})), False),
    "except": (lambda d, c, lib: d.select(lambda x: {"k": x["k"]})
               .except_(c.from_columns({"k": np.arange(
                   20, 60, dtype=np.int32)})), False),
    "union": (lambda d, c, lib: d.select(lambda x: {"k": x["k"]}).union(
        c.from_columns({"k": np.arange(35, 45, dtype=np.int32)})), False),
    "hash_partition": (lambda d, c, lib: d.hash_partition(["k"]).where(
        lambda x: x["k"] == 7), True),
    # a per-chunk apply_per_partition (each package's own Batch type)
    "apply": (lambda d, c, lib: d.apply_per_partition(
        lambda b: type(b)(dict(b.columns, w=b.columns["v"] * 3),
                          b.count)), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_query_equals_jax(store, case):
    """The query over ``read_store_stream`` in both packages: equal
    tables."""
    q, ordered = CASES[case]
    jc, tc = _jctx(), _tctx()
    exp = q(jc.read_store_stream(store, chunk_rows=CHUNK), jc,
            _Lib(True)).collect()
    got = q(tc.read_store_stream(store, chunk_rows=CHUNK), tc,
            _Lib(False)).collect()
    assert_tables(got, exp, ordered=ordered)


def test_stream_sources_and_terminals(store, data, tmp_path):
    """from_stream over a generator, count / take / skip / the scalars /
    first against numpy (and JAX for the scalars), to_store read back,
    and the terminal errors."""
    tc, jc = _tctx(), _jctx()
    ds = tc.read_store_stream(store, chunk_rows=CHUNK)
    jds = jc.read_store_stream(store, chunk_rows=CHUNK)
    assert ds.count() == N and ds.take(777).count() == 777
    assert ds.skip(1000).count() == N - 1000
    for kind in ("sum", "min", "max", "mean", "any", "all"):
        col = "f" if kind == "mean" else "v"
        got, exp = getattr(ds, kind)(col), getattr(jds, kind)(col)
        assert np.asarray(got).dtype == np.asarray(exp).dtype, kind
        np.testing.assert_allclose(got, exp, rtol=1e-6)
    assert ds.sum("v") == int(data["v"].sum())
    first = ds.first()
    assert first["k"] == data["k"][0] and first["v"] == data["v"][0]
    out = str(tmp_path / "sorted")
    ds.order_by([("v", False)]).to_store(out, compression="gzip")
    back = tc.from_store(out).collect()
    np.testing.assert_array_equal(back["v"], np.sort(data["v"]))

    def gen(i):
        return {"x": np.arange(i * 100, (i + 1) * 100, dtype=np.int32)}
    gs = tc.from_stream(TChunkSource.from_generator(gen, 9, 100))
    assert gs.where(lambda x: x["x"] % 2 == 0).count() == 450
    with pytest.raises(StreamExecutionError, match="string column"):
        tc.from_stream(TChunkSource.from_arrays(
            {"s": ["a", "b"]}, 8)).sum("s")


def test_stream_text_wordcount(tmp_path):
    """Streamed WordCount over a text file read line by line (CRLF lines,
    a last line with no newline): split_words then a count group-by,
    equal to the JAX package's and to a Counter."""
    words = ["alpha", "beta", "gamma", "delta", "epsilon"]
    rng = np.random.RandomState(5)
    lines = [" ".join(words[i] for i in rng.randint(0, 5, 7))
             for _ in range(3000)]
    p = tmp_path / "text.txt"
    p.write_bytes("\r\n".join(lines).encode())

    def q(ctx):
        return (ctx.read_text_stream(str(p), chunk_rows=CHUNK)
                .split_words("line", out_capacity=CHUNK * 8)
                .group_by(["line"], {"n": ("count", None)})).collect()
    got, exp = q(_tctx()), q(_jctx())
    assert_tables(got, exp)
    want = collections.Counter(w for ln in lines for w in ln.split())
    assert {w.decode(): int(n) for w, n in zip(got["line"], got["n"])} \
        == dict(want)


def test_stream_zip_and_right_join_wide_keys(tmp_path):
    """zip_with of two streams cut at different chunk sizes; a right /
    full join whose unmatched right keys are wider than the left key
    column arrives unclipped, as in the JAX package."""
    na, nb = 3_000, 2_400
    a, b = np.arange(na, dtype=np.int32), np.arange(nb, dtype=np.int32) * 7

    def mk(mod, arr, chunk):
        return mod.ChunkSource.from_generator(
            lambda i: {"x": arr[i * chunk:(i + 1) * chunk]},
            -(-len(arr) // chunk), chunk)
    tc, jc = _tctx(), _jctx()
    out = tc.from_stream(mk(ooc, a, 1024)).zip_with(
        tc.from_stream(mk(ooc, b, 640))).collect()
    np.testing.assert_array_equal(out["x"], a[:nb])
    np.testing.assert_array_equal(out["x_r"], b)

    lk = [b"a", b"bb", b"cc"] * 40
    left = {"key": lk, "v": np.arange(len(lk), dtype=np.int32)}
    lstore = str(tmp_path / "wide_left")
    TContext(device="cpu", nparts=2).from_columns(
        left, str_max_len=2).to_store(lstore)
    right = {"key": [b"bb", b"longkey!", b"xx"],
             "w": np.array([7, 8, 9], np.int32)}
    for how in ("right", "full"):
        got, exp = [
            ctx.read_store_stream(lstore, chunk_rows=50).join(
                ctx.from_columns(right, str_max_len=8), ["key"],
                expansion=3.0, how=how).collect() for ctx in (tc, jc)]
        assert_tables(got, exp)
        assert b"longkey!" in set(got["key"])


def test_stream_take_closes_and_cleans_up(store, tmp_path):
    """A take() closes the stream after the chunks it needs; the job
    directory (Tee spills, sort spill buckets under ``spill_dir``) is
    removed when the output stream ends or is closed early."""
    spill = str(tmp_path / "spill")
    os.makedirs(spill)
    tc = TContext(device="cpu", spill_dir=spill,
                  config=JobConfig(ooc_chunk_rows=CHUNK, ooc_incore_bytes=0))
    base = tc.read_store_stream(store, chunk_rows=CHUNK).select(
        lambda x: {"k": x["k"], "v": x["v"]})
    a, b = base.fork_by(lambda x: x["v"] > 0)
    out = a.concat(b).order_by([("v", False)]).collect()
    assert len(out["v"]) == N and os.listdir(spill) == []

    pulled = []
    src = TChunkSource.from_store(store, CHUNK)
    counting = TChunkSource(lambda: (pulled.append(1) or c for c in src),
                            src.schema, CHUNK)
    got = tc.from_stream(counting).take(700).collect()
    assert len(got["v"]) == 700 and len(pulled) == 2

    cs = tc.read_store_stream(store, chunk_rows=CHUNK).order_by(
        [("v", False)])._stream_run()
    it = iter(cs)
    next(it)
    assert len(os.listdir(spill)) == 1
    it.close()
    assert os.listdir(spill) == []


def test_stream_limits_and_auto_stream(store, data):
    """The ooc_join_build_rows refusal (JAX's text), the whole-group
    bucket bound, an apply_with_partition_index refusal, and
    ooc_auto_stream_rows switching from_store to the streamed path."""
    for mod_ctx in (_tctx(ooc_join_build_rows=10),
                    _jctx(ooc_join_build_rows=10)):
        ds = mod_ctx.read_store_stream(store, chunk_rows=CHUNK)
        with pytest.raises(Exception, match="ooc_join_build_rows=10") as e:
            ds.join(_dim(mod_ctx), ["k"]).collect()
        msg = str(e.value)
    tds = _tctx(ooc_join_build_rows=10).read_store_stream(store, CHUNK)
    with pytest.raises(StreamExecutionError) as te:
        tds.join(_dim(_tctx()), ["k"]).collect()
    assert str(te.value) == msg
    with pytest.raises(ooc.OOCError, match="ooc_group_bucket_rows"):
        _tctx(ooc_group_bucket_rows=8, ooc_hash_buckets=2).read_store_stream(
            store, CHUNK).group_median(["k"], "v").collect()
    with pytest.raises(StreamExecutionError,
                       match="apply_with_partition_index"):
        _tctx().read_store_stream(store, CHUNK).apply_with_partition_index(
            lambda b, i: b).collect()
    auto = _tctx(ooc_auto_stream_rows=1000).from_store(store)
    assert auto._streaming() and auto.count() == N
    assert not _tctx(ooc_auto_stream_rows=N + 1).from_store(
        store)._streaming()


def test_autotuned_chunk_rows(store, data):
    """With ``ooc_chunk_autotune`` and no chunk_rows, read_store_stream
    sizes its chunks with ``pick_chunk_rows`` from the store's row width
    (12 bytes, 3 lanes) and this device's measured rates; an explicit
    chunk_rows wins."""
    from dryad_tpu_torch.exec.autotune import measured_rates, \
        pick_chunk_rows
    ctx = _tctx(ooc_chunk_autotune=True)
    ds = ctx.read_store_stream(store)
    want = pick_chunk_rows(12, rates=measured_rates(device="cpu"),
                           row_lanes=3)
    assert ds.node.data.cs.chunk_rows == want and want % 4096 == 0
    assert ds.count() == N and ds.sum("v") == int(data["v"].sum())
    assert ctx.read_store_stream(store, 100).node.data.cs.chunk_rows == 100


def test_stream_entry_points_need_the_card_by_default(store):
    """Without CUDA the default Context raises; the streamed entry points
    on a CPU Context run the plain versions (the sweep above)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TContext().read_store_stream(store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(ooc.external_sort(TChunkSource.from_arrays(
            {"k": np.arange(4, dtype=np.int32)}, 2), [("k", False)]))


def test_device_source_keeps_its_string_width(tmp_path):
    """A device-resident source joined into a streamed query: the port
    moves its rows to the host at their own string width; the JAX
    package re-packs them at ``from_arrays``' default of 64 bytes
    (``dryad_tpu/exec/stream_exec.py:780``), so 81-byte names come back
    cut at 64 there (ROADMAP Queue 3, a reference-side difference)."""
    path = str(tmp_path / "s")
    TContext(device="cpu", nparts=2).from_columns(
        {"k": np.arange(10, dtype=np.int32)}).to_store(path)
    right = {"k": np.arange(10, dtype=np.int32),
             "name": [("n%d-" % i) + "x" * 78 for i in range(10)]}
    got, exp = [ctx.read_store_stream(path, chunk_rows=4).join(
        ctx.from_columns(right, str_max_len=96), ["k"]).collect()
        for ctx in (_tctx(), _jctx())]
    want = sorted(s.encode() for s in right["name"])
    assert sorted(got["name"]) == want
    assert sorted(exp["name"]) == [s[:64] for s in want]
