"""The port's event log (``utils/events.py``): the JSONL file, the level
filter, ``job_report``, against the JAX package's on the same plans and
numpy inputs (mirrors ``tests/test_store_recovery.py``'s event case and
``tests/test_obs.py``'s drift test)."""

import json
import pathlib
import re

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.utils import events as jevents
from dryad_tpu_torch import Context as TContext
import dryad_tpu_torch
from dryad_tpu_torch.utils import events
from dryad_tpu_torch.utils.events import EventLog, job_report
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
PKG = pathlib.Path(dryad_tpu_torch.__file__).resolve().parent


def _cols(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 12, n).astype(np.int32),
            "v": rng.randint(0, 1000, n).astype(np.int32)}


def _query(ctx):
    """A retrying order_by and a group_by computed from it: stage_done,
    settle_replay, progress and job_done events."""
    return ctx.from_columns(_cols()).order_by(
        [("k", False), ("v", True)]).group_by(["v"], {"n": ("count", None)})


def test_jsonl_lines_equal_the_memory_events(devices8, tmp_path):
    path = str(tmp_path / "events.jsonl")
    with EventLog(path) as log:
        _query(TContext(device="cpu", nparts=P, event_log=log)).collect()
    with open(path) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    assert lines == log.events and len(lines) > 5
    assert log.closed
    # after close an event stays in memory and never reaches the file
    log({"event": "stage_done", "stage": 99})
    assert log.events[-1]["stage"] == 99
    with open(path) as f:
        assert len(f.read().splitlines()) == len(lines)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_level_filter(devices8, level, monkeypatch):
    monkeypatch.setenv("DRYAD_LOGGING_LEVEL", str(level))
    log = EventLog()
    assert log.level == level
    ctx = TContext(device="cpu", nparts=P, event_log=log)
    _query(ctx).collect()
    kinds = {e["event"] for e in log.events}
    want = {0: set(),
            1: {"plan", "stage_done", "settle_replay", "job_done"},
            2: {"plan", "stage_done", "settle_replay", "job_done",
                "progress", "span", "resource_sample"}}
    assert kinds == want[level]
    assert log.admits("stage_replay") and log.admits("an_unknown_kind")
    assert log.admits("progress") == (level == 2)


def test_job_report_names_the_stage_labels(devices8):
    log = EventLog()
    ctx = TContext(device="cpu", nparts=P, event_log=log)
    _query(ctx).collect()
    rep = job_report(log)
    for st in ctx.executor.stage_log:
        assert st["label"] in rep
    assert job_report(log.events) == rep


def _report_rows(rep):
    """The report's rows without the wall_s column (host time)."""
    return [line.split()[:-1] for line in rep.splitlines()]


def test_job_report_matches_jax(devices8):
    """The same plan in both packages (``explain()`` equal): the same
    stages, labels, runs (the deferred attempt and the settle's replays),
    retries, replays and scales."""
    tlog, jlog = EventLog(), jevents.EventLog()
    t = TContext(device="cpu", nparts=P, event_log=tlog)
    j = JContext(event_log=jlog)
    assert _query(t).explain() == _query(j).explain()
    _query(t).collect()
    _query(j).collect()
    rows = _report_rows(job_report(tlog))
    assert rows == _report_rows(jevents.job_report(jlog))
    assert [r[2] for r in rows[1:]] == ["1", "2", "2"]


def test_levels_table_is_the_jax_packages(devices8):
    assert events._LEVELS == jevents._LEVELS


def test_every_emitted_kind_is_registered():
    """Every ``{"event": ...}`` literal under dryad_tpu_torch/ has a level
    (an unregistered kind would pass every filter)."""
    pat = re.compile(r"""["']event["']\s*:\s*["']([a-z_]+)["']""")
    found = set()
    for path in PKG.rglob("*.py"):
        found |= set(pat.findall(path.read_text()))
    assert {"stage_done", "settle_replay", "stage_replay", "stage_spilled",
            "stage_restored", "progress", "job_done"} <= found
    assert found <= set(events._LEVELS), found - set(events._LEVELS)
