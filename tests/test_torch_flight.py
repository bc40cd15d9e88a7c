"""Failure forensics in the port (``dryad_tpu_torch/obs/flight.py``) on
the CPU: the flight ring, a bundle's round trip and its replay, the
driver-side placement of a failing reply's bundle, and the whole chain
over real worker processes (one module-scoped ``LocalCluster(2, 2,
device="cpu")``): a farm wordcount whose UDF raises on one poison task
raises ``FarmError`` naming the persisted bundle, a ``task_forensics``
event points at it, and ``python -m dryad_tpu_torch.obs replay <bundle>
--device cpu`` in a fresh interpreter prints ``REPRODUCED``."""

import json
import os
import pickle
import subprocess
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_cluster_fns as F  # noqa: E402

from dryad_tpu_torch import Context, JobConfig  # noqa: E402
from dryad_tpu_torch.apps.wordcount import wordcount_query  # noqa: E402
from dryad_tpu_torch.obs import flight  # noqa: E402
from dryad_tpu_torch.obs.__main__ import main as obs_main  # noqa: E402
from dryad_tpu_torch.plan.planner import plan_query  # noqa: E402
from dryad_tpu_torch.runtime import LocalCluster, protocol  # noqa: E402
from dryad_tpu_torch.runtime.farm import FarmError, TaskFarm  # noqa: E402
from dryad_tpu_torch.runtime.shiplan import \
    serialize_for_cluster  # noqa: E402
from dryad_tpu_torch.runtime.sources import columns_spec  # noqa: E402
from dryad_tpu_torch.utils.events import EventLog  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(HERE)
LINES = ["alpha beta gamma", "alpha alpha", "beta gamma",
         "gamma gamma gamma"]


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


def _wc_plan(nparts=2):
    """A wordcount plan whose source passes through the poison UDF."""
    ctx = Context(cluster=types.SimpleNamespace(
        devices_per_process=nparts))
    ds = ctx.from_columns({"line": ["seed"]}, str_max_len=64)
    q = wordcount_query(ds.select(F.poison_wide_lines),
                        tokens_per_partition=64)
    plan_json, specs = serialize_for_cluster(plan_query(q.node, nparts))
    (src_key,) = specs
    return plan_json, src_key


def _bundle(width=64, exc=None):
    plan_json, src_key = _wc_plan()
    msg = {"plan": plan_json, "task": 0, "job": 1, "config": None,
           "sources": {src_key: columns_spec({"line": LINES}, 2,
                                             str_max_len=width)}}
    return flight.capture_bundle(msg, exc or ValueError("fixture"),
                                 worker=0, fn_modules=["torch_cluster_fns"],
                                 device="cpu", nparts=2)


def test_flight_ring_is_bounded():
    for i in range(flight._RING_CAP + 50):
        flight.record({"event": "progress", "i": i})
    ring = flight.ring_events()
    assert len(ring) == flight._RING_CAP
    assert ring[-1]["i"] == flight._RING_CAP + 49


def test_bundle_round_trip_and_clean_replay(tmp_path):
    b = _bundle()
    assert b["dryad_forensics"] == 1 and b["kind"] == "task"
    assert (b["device"], b["nparts"]) == ("cpu", 2)
    assert b["error"] == {"type": "ValueError", "message": "fixture",
                          "traceback": b["error"]["traceback"]}
    assert set(b["source_digests"]) == set(b["sources"])
    path = flight.persist_bundle(b, str(tmp_path / "b"))
    assert os.path.basename(path).startswith("task-job1-task0-")
    loaded = flight.load_bundle(path)
    assert loaded["plan"] == b["plan"]
    # the fixture's task is healthy: replay completes with its counts
    from dryad_tpu_torch.exec.data import pdata_to_host
    out = pdata_to_host(flight.replay_bundle(loaded))
    got = dict(zip(out["line"], (int(n) for n in out["n"])))
    assert got == {b"alpha": 3, b"beta": 2, b"gamma": 5}


def test_load_bundle_rejects_non_bundles(tmp_path):
    p = tmp_path / "junk"
    p.write_bytes(b"\x00\x01 not a pickle")
    with pytest.raises(Exception):
        flight.load_bundle(str(p))
    p2 = tmp_path / "notbundle"
    p2.write_bytes(pickle.dumps({"some": "dict"}))
    with pytest.raises(flight.BundleError):
        flight.load_bundle(str(p2))
    with pytest.raises(flight.BundleError, match="no plan"):
        flight.replay_bundle({"dryad_forensics": 1})
    assert obs_main(["replay", str(p2)]) == 2


def test_persist_reply_forensics_placement(tmp_path):
    """A reply's bundle lands in ``forensics_dir``, else beside the
    event log's JSONL, else in a temp dir; each emits ``task_forensics``;
    a reply without a bundle persists nothing."""
    reply = protocol.attach_forensics({"ok": False}, _bundle())
    got = []
    p1 = flight.persist_reply_forensics(
        reply, JobConfig(forensics_dir=str(tmp_path / "f")), None,
        got.append)
    assert os.path.dirname(p1) == str(tmp_path / "f")
    log = EventLog(str(tmp_path / "ev.jsonl"))
    p2 = flight.persist_reply_forensics(reply, JobConfig(), log,
                                        got.append)
    log.close()
    assert os.path.dirname(p2) == str(tmp_path / "bundles")
    p3 = flight.persist_reply_forensics(reply, None, None, got.append)
    assert os.path.exists(p3)
    assert [e["path"] for e in got] == [p1, p2, p3]
    assert all(e["event"] == "task_forensics" and e["task"] == 0
               and e["error_type"] == "ValueError" for e in got)
    assert flight.persist_reply_forensics({"ok": False}, None, None,
                                          got.append) is None


def test_poison_task_bundle_replays_reproduced(cluster, tmp_path):
    """The acceptance chain on worker processes: a healthy farm, then the
    same plan with one poison task (a wider string column) raises
    FarmError naming the bundle; the bundle carries the worker's device
    type, partitions and flight ring; the CLI replays it in a fresh
    interpreter on the CPU and prints REPRODUCED."""
    plan_json, src_key = _wc_plan(cluster.devices_per_process)
    good = [{src_key: columns_spec({"line": [ln]}, 2, str_max_len=64)}
            for ln in LINES]
    bundles = str(tmp_path / "bundles")
    jsonl = str(tmp_path / "events.jsonl")
    cfg = JobConfig(forensics_dir=bundles)
    with EventLog(jsonl) as log:
        cluster.event_log = log
        try:
            farm = TaskFarm(cluster, min_samples=10**9, config=cfg)
            out = farm.run(plan_json, good)
            total = sum(int(n) for t in out for n in t["n"])
            assert total == sum(len(ln.split()) for ln in LINES)
            poison = {src_key: columns_spec({"line": [LINES[0]]}, 2,
                                            str_max_len=128)}
            with pytest.raises(FarmError) as ei:
                farm.run(plan_json, good[:3] + [poison])
        finally:
            cluster.event_log = None
    msg = str(ei.value)
    assert "poison partition: line bytes 128 > 64" in msg
    assert "python -m dryad_tpu_torch.obs replay" in msg
    (name,) = os.listdir(bundles)
    bpath = os.path.join(bundles, name)
    assert f"forensics bundle: {bpath}" in msg
    b = flight.load_bundle(bpath)
    assert (b["device"], b["nparts"], b["task"]) == ("cpu", 2, 3)
    assert b["fn_modules"] == ["torch_cluster_fns"] and b["events"]
    assert "poison partition" in b["error"]["message"]
    with open(jsonl) as f:
        tf = [e for e in map(json.loads, f)
              if e.get("event") == "task_forensics"]
    assert tf and tf[0]["path"] == bpath
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + ROOT,
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "dryad_tpu_torch.obs", "replay", bpath,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "verdict  : REPRODUCED" in res.stdout
    assert "2 partition(s) on cpu" in res.stdout
