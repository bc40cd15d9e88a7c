"""The port's re-streaming chunk cache (``Dataset.cache()`` of streamed and
edge-scale data, ``exec/ooc.py``'s cache tier), mirroring
``tests/test_ooc_cache.py``: the cold pass writes a fingerprinted local
chunked store, warm passes re-stream it, a restarted process with the
same ``ooc_cache_dir`` skips the cold pass, changed source bytes miss
the key, and a corrupt entry falls back to a clean re-stream — never
wrong rows.  Rows are compared exactly with numpy and with the JAX
package's cached query; the cache keys are the JAX package's algorithm
over the port's nodes (compared by their restart stability, not by
value)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.obs.metrics import REGISTRY, family_counter
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

CHUNK = 512
N = 8000
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    return {"k": rng.randint(0, 40, N).astype(np.int32),
            "v": rng.randint(-1000, 1000, N).astype(np.int32)}


@pytest.fixture(scope="module")
def store(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache") / "src")
    TContext(device="cpu", nparts=4).from_columns(data).to_store(path)
    return path


def _ctx(cache_dir, log=None, **over):
    return TContext(device="cpu", event_log=log, config=JobConfig(
        ooc_chunk_rows=CHUNK, ooc_cache_dir=str(cache_dir), **over))


def _kinds(log):
    return [e["event"] for e in log.events
            if e["event"].startswith("ooc_cache")]


def _positive(ctx, store):
    return (ctx.read_store_stream(store, chunk_rows=CHUNK)
            .where(lambda c: c["v"] > 0).cache())


def test_cold_write_then_warm_hits(store, data, tmp_path):
    """One ooc_cache_write, then one ooc_cache_hit per pass; the entry is
    the store layout plus its sidecar; the metric families count both;
    the rows equal numpy's and the JAX package's cached query."""
    hits = family_counter(REGISTRY, "ooc_cache_hits").value
    writes = family_counter(REGISTRY, "ooc_cache_writes").value
    log = EventLog(level=2)
    ds = _positive(_ctx(tmp_path / "cc", log), store)
    got = ds.collect()
    assert ds.count() == int((data["v"] > 0).sum())
    np.testing.assert_array_equal(got["v"], data["v"][data["v"] > 0])
    kinds = _kinds(log)
    assert kinds.count("ooc_cache_write") == 1
    assert kinds.count("ooc_cache_hit") == 2
    assert family_counter(REGISTRY, "ooc_cache_hits").value == hits + 2
    assert family_counter(REGISTRY, "ooc_cache_writes").value == writes + 1
    (entry,) = glob.glob(str(tmp_path / "cc" / "ooc-cache-*"))
    assert os.path.exists(os.path.join(entry, "data", "meta.json"))
    assert os.path.exists(os.path.join(entry, "cache.json"))
    jds = (JContext(config=JJobConfig(ooc_chunk_rows=CHUNK,
                                      ooc_cache_dir=str(tmp_path / "jc")))
           .read_store_stream(store, chunk_rows=CHUNK)
           .where(lambda c: c["v"] > 0).cache())
    np.testing.assert_array_equal(got["v"], np.asarray(jds.collect()["v"]))


def test_restart_in_a_new_process_skips_the_cold_pass(store, tmp_path):
    """The key is restart-stable: a second process with the same
    ooc_cache_dir computes the same key, finds the entry warm (no
    ooc_cache_write) and serves the same rows; the derived cache of a
    cached stream (the pagerank_stream shape) is warm too."""
    prog = f"""
import sys
sys.path.insert(0, {_REPO!r})
from dryad_tpu_torch import Context, JobConfig
from dryad_tpu_torch.api.dataset import _stable_node_fp
from dryad_tpu_torch.utils.events import EventLog
log = EventLog(level=2)
ctx = Context(device="cpu", event_log=log, config=JobConfig(
    ooc_chunk_rows={CHUNK}, ooc_cache_dir={str(tmp_path / "cc")!r}))
edges = ctx.read_store_stream({store!r}, chunk_rows={CHUNK}).cache()
deg = edges.group_by(["k"], {{"n": ("count", None)}}).cache()
n = deg.count()
kinds = [e["event"] for e in log.events if e["event"].startswith("ooc")]
print(_stable_node_fp(deg.node.parents[0] if deg.node.parents else
                      deg.node), n, kinds.count("ooc_cache_write"),
      kinds.count("ooc_cache_hit"))
"""
    outs = [subprocess.run([sys.executable, "-c", prog],
                           capture_output=True, text=True, check=True,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
            .stdout.split() for _ in range(2)]
    assert outs[0][:2] == outs[1][:2] and outs[0][1] == "40"
    assert outs[0][2:] == ["2", "2"]   # cold: both entries written
    assert outs[1][2:] == ["0", "1"]   # warm: the derived entry serves


def test_corrupt_entry_restreams_clean(store, data, tmp_path):
    """A chunk whose bytes no longer match its checksum invalidates the
    entry mid-stream; the rest comes from a clean re-stream of the query,
    row-exact; the next pass writes the entry again."""
    log = EventLog(level=2)
    ds = _positive(_ctx(tmp_path / "cc", log), store)
    ds.count()
    parts = sorted(glob.glob(str(tmp_path / "cc") + "/*/data/part-*.bin"))
    assert len(parts) > 3
    with open(parts[2], "r+b") as f:
        f.seek(8)
        f.write(b"\xde\xad\xbe\xef")
    out = ds.collect()
    assert "ooc_cache_invalid" in _kinds(log)
    np.testing.assert_array_equal(out["v"], data["v"][data["v"] > 0])
    assert ds.count() == int((data["v"] > 0).sum())
    assert _kinds(log).count("ooc_cache_write") == 2


def test_changed_source_bytes_miss(data, tmp_path):
    """The key folds in the store's checksums: a store rewritten with
    other data at the same path misses the old entry."""
    sp = str(tmp_path / "src")
    TContext(device="cpu", nparts=2).from_columns(data).to_store(sp)
    cc = tmp_path / "cc"
    assert _ctx(cc).read_store_stream(sp, chunk_rows=CHUNK).cache().sum(
        "v") == int(data["v"].sum())
    new = {"k": data["k"], "v": (data["v"] * 3).astype(np.int32)}
    TContext(device="cpu", nparts=2).from_columns(new).to_store(sp)
    assert _ctx(cc).read_store_stream(sp, chunk_rows=CHUNK).cache().sum(
        "v") == int(new["v"].sum())
    assert len(glob.glob(str(cc / "ooc-cache-*"))) == 2


def test_cache_off_lever(store, data, tmp_path):
    """ooc_restream_cache=False: the unvalidated temporary store, no
    cache events, no entry under the cache root, the same rows."""
    log = EventLog(level=2)
    ds = _positive(_ctx(tmp_path / "cc", log, ooc_restream_cache=False),
                   store)
    assert ds.count() == int((data["v"] > 0).sum())
    assert _kinds(log) == []
    assert glob.glob(str(tmp_path / "cc" / "ooc-cache-*")) == []


def test_edge_scale_inmemory_cache_lowers_to_store(tmp_path):
    """In-memory data past DTA204's fraction of device_hbm_bytes: cache()
    writes a local store and returns a streamed read of it (rows
    unchanged); below it, or with the tier off, the cache stays on the
    device."""
    rng = np.random.RandomState(1)
    x = {"k": rng.randint(0, 50, 4000).astype(np.int32),
         "f": rng.randn(4000, 16).astype(np.float32)}
    log = EventLog(level=2)
    ctx = _ctx(tmp_path / "cc", log, device_hbm_bytes=1 << 16)
    cached = ctx.from_columns(x).where(lambda c: c["k"] < 25).cache()
    assert cached._streaming()
    assert _kinds(log) == ["ooc_cache_write"]
    got = cached.collect()
    keep = x["k"] < 25
    assert sorted(got["k"].tolist()) == sorted(x["k"][keep].tolist())
    np.testing.assert_array_equal(np.sort(got["f"].sum(1)),
                                  np.sort(x["f"][keep].sum(1)))
    assert _kinds(log) == ["ooc_cache_write", "ooc_cache_hit"]
    for cfg in ({"device_hbm_bytes": 1 << 30},
                {"device_hbm_bytes": 1 << 16, "ooc_restream_cache": False}):
        c2 = _ctx(tmp_path / "c2", **cfg)
        assert not c2.from_columns(x).cache()._streaming()
