"""The port's local store (``io/store.py``), spill and resume, ``read_text``
and its C checksum, against the JAX package with the same numpy inputs
(mirrors ``tests/test_store_recovery.py``).

Stores cross between the packages in both directions with equal rows;
the same data written by both gives part files that are byte-identical
and ``meta.json`` files equal but for ``native_io`` (the checksum engine
that ran).  Tolerance: none."""

import collections
import glob
import json
import os

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu import native
from dryad_tpu.io.store import StoreIntegrityError as JIntegrityError
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.exec.data import pdata_to_host
from dryad_tpu_torch.exec.executor import Executor
from dryad_tpu_torch.exec.recovery import Run
from dryad_tpu_torch.io import fnv
from dryad_tpu_torch.io.store import StoreIntegrityError, store_meta
from dryad_tpu_torch.plan.planner import plan_query
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _cols(n=300, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 9, n).astype(np.int32),
            "v": rng.randn(n).astype(np.float32),
            "s": ["id%d" % i for i in rng.randint(0, 30, n)]}


def _rows(table):
    cols = sorted(table)
    vals = [list(table[c]) if isinstance(table[c], list)
            else np.asarray(table[c]).tolist() for c in cols]
    return collections.Counter(zip(*vals))


def _want(cols):
    return _rows({k: ([s.encode() for s in v] if isinstance(v, list)
                      else v) for k, v in cols.items()})


def _tctx(nparts=P, **kw):
    return TContext(device="cpu", nparts=nparts, **kw)


def _parts(path):
    return sorted(glob.glob(os.path.join(path, "part-*.bin")))


@pytest.mark.parametrize("comp", [None, "gzip"])
def test_port_store_reads_in_jax(devices8, tmp_path, comp):
    cols = _cols()
    path = str(tmp_path / "t")
    _tctx().from_columns(cols, capacity=64).to_store(path, compression=comp)
    assert _rows(JContext().from_store(path).collect()) == _want(cols)


@pytest.mark.parametrize("comp", [None, "gzip"])
def test_jax_store_reads_in_port(devices8, tmp_path, comp):
    cols = _cols(seed=1)
    path = str(tmp_path / "j")
    JContext().from_columns(cols, capacity=64).to_store(path,
                                                        compression=comp)
    assert _rows(_tctx().from_store(path).collect()) == _want(cols)


@pytest.mark.parametrize("comp", [None, "gzip"])
def test_same_data_same_files(devices8, tmp_path, comp):
    """Part files byte for byte, checksums and meta.json equal but for
    ``native_io``, hash placement included."""
    cols = _cols(seed=2)
    tp, jp = str(tmp_path / "t"), str(tmp_path / "j")
    _tctx().from_columns(cols, capacity=64).hash_partition(["k"]).to_store(
        tp, compression=comp)
    JContext().from_columns(cols, capacity=64).hash_partition(
        ["k"]).to_store(jp, compression=comp)
    tmeta, jmeta = (json.load(open(os.path.join(p, "meta.json")))
                    for p in (tp, jp))
    assert tmeta.pop("native_io") == "dryad_tpu_torch host_fnv.c"
    jmeta.pop("native_io")
    assert tmeta == jmeta
    assert tmeta["partitioning"] == {"kind": "hash", "keys": ["k"]}
    assert [os.path.basename(p) for p in _parts(tp)] == \
        [os.path.basename(p) for p in _parts(jp)]
    for a, b in zip(_parts(tp), _parts(jp)):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_gzip_is_smaller_and_round_trips(devices8, tmp_path):
    cols = _cols(n=2000)
    ds = _tctx().from_columns(cols)
    ds.to_store(str(tmp_path / "gz"), compression="gzip")
    _tctx(config=JobConfig(store_compression="gzip")).from_columns(
        cols).to_store(str(tmp_path / "cfg"))
    ds.to_store(str(tmp_path / "raw"))
    assert store_meta(str(tmp_path / "gz"))["compression"] == "gzip"
    assert store_meta(str(tmp_path / "cfg"))["compression"] == "gzip"
    size = {d: sum(os.path.getsize(p) for p in _parts(str(tmp_path / d)))
            for d in ("gz", "raw")}
    assert size["gz"] < size["raw"]
    assert _rows(_tctx().from_store(str(tmp_path / "gz")).collect()) == \
        _want(cols)
    with pytest.raises(ValueError, match="unknown compression"):
        ds.to_store(str(tmp_path / "x"), compression="lz4")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flipped_byte_names_the_partition(devices8, tmp_path, writer):
    path = str(tmp_path / "chk")
    ctx = _tctx() if writer == "port" else JContext()
    ctx.from_columns(_cols(), capacity=64).to_store(path)
    part = os.path.join(path, "part-00003.bin")
    raw = bytearray(open(part, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(part, "wb").write(bytes(raw))
    with pytest.raises(StoreIntegrityError, match="partition 3"):
        _tctx().from_store(path).collect()
    with pytest.raises(JIntegrityError, match="partition 3"):
        JContext().from_store(path).collect()
    # without verification the port reads the bytes as they are
    cfg = JobConfig(store_verify_checksums=False)
    assert len(_tctx(config=cfg).from_store(path).collect()["k"]) == 300


def test_partitioning_kept_at_the_same_partition_count(devices8, tmp_path):
    cols = _cols()
    path = str(tmp_path / "hashed")
    _tctx().from_columns(cols, capacity=64).hash_partition(["k"]).to_store(
        path)
    q = _tctx().from_store(path).group_by(["k"], {"n": ("count", None)})
    assert "=>hash" not in q.explain()
    got = q.collect()
    keys, counts = np.unique(cols["k"], return_counts=True)
    order = np.argsort(got["k"])
    np.testing.assert_array_equal(got["k"][order], keys)
    np.testing.assert_array_equal(got["n"][order], counts)


def test_partitioning_dropped_at_another_partition_count(devices8,
                                                         tmp_path):
    cols = _cols()
    path = str(tmp_path / "hashed")
    _tctx().from_columns(cols, capacity=64).hash_partition(["k"]).to_store(
        path)
    four = _tctx(nparts=4).from_store(path)
    assert four.group_by(["k"], {"n": ("count", None)}).explain().count(
        "=>hash") == 1
    assert _rows(four.collect()) == _want(cols)
    # the JAX package re-blocks the same way
    jfour = JContext().from_store(path)
    assert _rows(jfour.collect()) == _want(cols)


def _graph(ctx, cols):
    q = ctx.from_columns(cols, capacity=64).hash_partition(["k"]).group_by(
        ["k"], {"n": ("count", None), "t": ("sum", "v")})
    return plan_query(q.node, P)


@pytest.mark.parametrize("comp", [None, "gzip"])
def test_spill_and_resume_without_recomputing(devices8, tmp_path, comp):
    """Run 1 spills every stage; a fresh executor and Run over the same
    graph restores the output stage and computes nothing."""
    ctx = _tctx()
    graph = _graph(ctx, _cols())
    spill = str(tmp_path / "spill")
    log1 = EventLog()
    run1 = Run(ctx.executor, graph, spill_dir=spill, event=log1,
               spill_compression=comp)
    out1 = pdata_to_host(run1.output())
    assert sorted(e["stage"] for e in log1.of_type("stage_spilled")) == \
        list(range(len(graph.stages)))
    assert {e["stage"] for e in log1.of_type("stage_done")} == \
        set(range(len(graph.stages)))
    assert store_meta(os.path.join(spill, "stage-0000"))["compression"] \
        == comp
    log2 = EventLog()
    run2 = Run(Executor(ctx.mesh), graph, spill_dir=spill, event=log2,
               spill_compression=comp)
    out2 = pdata_to_host(run2.output())
    assert _rows(out2) == _rows(out1)
    assert log2.of_type("stage_done") == []
    assert [e["stage"] for e in log2.of_type("stage_restored")] == \
        [graph.out_stage]


def test_drop_spill_recomputes_only_the_last_stage(devices8, tmp_path):
    """The hash-partitioned intermediate is restored verbatim, so the
    group_by (its exchange elided) recomputes right on top of it."""
    cols = _cols()
    ctx = _tctx()
    graph = _graph(ctx, cols)
    spill = str(tmp_path / "spill")
    out1 = pdata_to_host(Run(ctx.executor, graph, spill_dir=spill).output())
    log = EventLog()
    run = Run(Executor(ctx.mesh), graph, spill_dir=spill, event=log)
    run.invalidate(graph.out_stage, count_failure=False, drop_spill=True)
    assert not os.path.exists(os.path.join(
        spill, f"stage-{graph.out_stage:04d}"))
    out2 = pdata_to_host(run.output())
    assert _rows(out2) == _rows(out1)
    assert [e["stage"] for e in log.of_type("stage_done")] == \
        [graph.out_stage]
    assert {e["stage"] for e in log.of_type("stage_restored")} == \
        set(graph.stage(graph.out_stage).input_stage_ids())
    keys, counts = np.unique(cols["k"], return_counts=True)
    order = np.argsort(out2["k"])
    np.testing.assert_array_equal(out2["k"][order], keys)
    np.testing.assert_array_equal(out2["n"][order], counts)


def test_context_spill_dir_spills_every_query(devices8, tmp_path):
    spill = str(tmp_path / "ctx_spill")
    ctx = _tctx(spill_dir=spill)
    out = ctx.from_columns(_cols()).group_by(
        ["k"], {"n": ("count", None)}).collect()
    assert sum(out["n"]) == 300
    assert sorted(os.listdir(spill)) == [
        f"stage-{st['stage']:04d}" for st in ctx.executor.stage_log]
    # the spill path reads every stage attempt back: no deferral
    assert ctx.executor.host_reads == sum(
        st["attempts"] for st in ctx.executor.stage_log)


def _text_files(d):
    """Three files: CRLF lines, an empty line, a line past max_line_len,
    no trailing newline in the last."""
    os.makedirs(d)
    texts = [b"the quick brown fox\r\njumps over\n\n" + b"x" * 100 +
             b"\nthe lazy dog\n",
             b"y" * 40 + b"\nshort\r\n",
             b"alpha beta\ngamma"]
    for i, t in enumerate(texts):
        with open(os.path.join(d, f"f{i}.txt"), "wb") as f:
            f.write(t)
    return texts


@pytest.mark.parametrize("spec", ["file", "glob", "dir", "list"])
def test_read_text_matches_jax(devices8, tmp_path, spec):
    d = str(tmp_path / "txt")
    _text_files(d)
    path = {"file": os.path.join(d, "f0.txt"),
            "glob": os.path.join(d, "f*.txt"), "dir": d,
            "list": [os.path.join(d, "f2.txt"),
                     os.path.join(d, "f0.txt")]}[spec]
    got = _tctx().read_text(path, max_line_len=32).collect()
    want = JContext().read_text(path, max_line_len=32).collect()
    assert got["line"] == want["line"]
    assert b"" in got["line"] and max(map(len, got["line"])) == 32


def test_read_text_wordcount_equals_in_memory(devices8, tmp_path):
    from dryad_tpu_torch.apps.wordcount import wordcount, wordcount_query
    lines = ["a b c", "b c", "c d e f", "", "A a"] * 40
    p = str(tmp_path / "corpus.txt")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    ctx = _tctx()
    got = wordcount_query(ctx.read_text(p)).collect()
    want = wordcount(_tctx(), lines)
    assert dict(zip(got["line"], got["n"].tolist())) == \
        dict(zip(want["line"], want["n"].tolist()))
    with pytest.raises(FileNotFoundError):
        ctx.read_text(str(tmp_path / "none*.txt"))


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 100_003])
def test_c_fnv_matches_python_and_jax(n):
    buf = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8)
    want = fnv.fnv64_py(buf.tobytes())
    assert fnv.fnv64(buf) == want
    assert native.checksum_segments([buf]) == want
    seed = 0x0123456789ABCDEF
    assert fnv.fnv64(buf, seed) == fnv.fnv64_py(buf.tobytes(), seed)


def test_chained_segments_equal_the_concatenation():
    rng = np.random.RandomState(5)
    segs = [rng.randint(0, 256, (13, 24)).astype(np.uint8),
            rng.randint(-5, 5, 13).astype(np.int32), np.zeros(0, np.int32),
            rng.rand(13, 2).astype(np.float32), rng.rand(3) > 0.5]
    whole = b"".join(s.tobytes() for s in segs)
    assert fnv.checksum_segments(segs) == fnv.fnv64_py(whole) == \
        native.checksum_segments(segs)


def test_host_library_builds_once_under_concurrent_first_use(
        tmp_path, monkeypatch):
    """The store checksums partitions on a thread pool, so the checksum
    library's first use may come from 8 threads at once, with no build
    there yet: every thread gets the library, built once."""
    import concurrent.futures

    from dryad_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(_build, "_HOST_LOADED", {})
    segs = [[np.full(1000, i, np.uint8)] for i in range(16)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(fnv.checksum_segments, segs))
    assert got == [fnv.fnv64_py(s[0].tobytes()) for s in segs]
    assert [p.name for p in (tmp_path / "host").iterdir()] == [
        _build._host_lib_path("host_fnv").name]


def test_remote_paths_wait_for_their_item(devices8, monkeypatch):
    """The remote stores have come (ROADMAP Queue 1 item 10.4): an
    ``s3://`` and an ``hdfs://`` store round trip on the loopback fakes,
    readable by the JAX package, and ``read_text`` of a URL is a missing
    file, as in the JAX package (``Context.read`` reads URLs)."""
    import sys

    from dryad_tpu_torch.io import s3_store
    from tests.torch_fakes import FakeS3
    sys.path.insert(0, os.path.dirname(__file__))
    from webhdfs_fake import FakeWebHdfs
    cols = _cols(n=16)
    ds = _tctx().from_columns(cols)
    hdfs = FakeWebHdfs()
    try:
        with FakeS3() as fake:
            for k, v in fake.environ().items():
                monkeypatch.setenv(k, v)
            monkeypatch.setattr(s3_store, "_CLIENT", None)
            for url in ("s3://bucket/t", hdfs.url + "/t"):
                ds.to_store(url)
                assert _rows(_tctx().from_store(url).collect()) == \
                    _want(cols)
                assert _rows(JContext().from_store(url).collect()) == \
                    _want(cols)
    finally:
        hdfs.close()
    with pytest.raises(FileNotFoundError):
        _tctx().read_text("http://127.0.0.1:1/t.txt")
