"""The port's measured exchange send slots (``exec/executor.py``:
``_quantize_slot_rows``, ``_probe_slot_rows``, ``_note_slot_feedback``,
``_slot_hints``; ``parallel/shuffle.send_slot_rows``) against the JAX
package's: the quantization and the probe's slot equal the JAX functions
on the same inputs; the sources run in the JAX order (feedback, probe,
slack); no hints on a salted attempt or at P = 1; a stale feedback slot
that falls short retries for slack and loses no row;
``exchange_probe_min_mb = -1`` ships the structural slot.

Tolerance: none.  Slots are integers and compare exactly; rows compare
exactly as multisets."""

import collections

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.exec import executor as jexec
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.exec import executor as texec
from dryad_tpu_torch.exec.recovery import Run
from dryad_tpu_torch.ops.hashing import hash_columns
from dryad_tpu_torch.plan.stages import Exchange, Leg, Stage, StageGraph
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _rows(t):
    names = sorted(t)
    cols = [[bytes(x) for x in t[c]] if isinstance(t[c], list)
            else np.asarray(t[c]).tolist() for c in names]
    return collections.Counter(zip(*cols))


def _ctx(mb=0.0, nparts=P):
    return TContext(device="cpu", nparts=nparts,
                    config=JobConfig(exchange_probe_min_mb=mb))


def _run(ctx):
    """A Run of an empty graph on ``ctx``'s executor: the calling run the
    slot helpers count their probes in."""
    return Run(ctx.executor, StageGraph([], 0))


def _log(ctx, label="hashpartition"):
    (st,) = [s for s in ctx.executor.stage_log if s["label"] == label]
    return st


def test_quantize_matches_jax():
    rng = np.random.RandomState(0)
    vals = np.concatenate([np.arange(0, 40), [63, 64, 65, 255, 256, 257],
                           rng.randint(0, 2_000_000, 154)])
    assert len(vals) == 200
    for v in vals.tolist():
        assert texec._quantize_slot_rows(v) == jexec._quantize_slot_rows(v)


def _skewed(n, seed, hot):
    rng = np.random.RandomState(seed)
    k = np.where(rng.rand(n) < hot, 7, rng.randint(0, 5000, n))
    return {"k": k.astype(np.int32),
            "v": rng.randn(n).astype(np.float32),
            "s": [f"key{x % 97}".encode() for x in k.tolist()]}


@pytest.mark.parametrize("hot,keys,slack,n,cap", [
    (0.0, ("k",), 2, 4000, None), (0.3, ("k",), 2, 4000, 700),
    (0.9, ("k",), 2, 4000, None), (0.0, ("s",), 4, 3000, None),
    (0.2, ("k", "s"), 2, 1000, 400), (0.0, ("k",), 2, 0, 64),
    (0.0, ("k",), 16, 64, None)])
def test_probe_matches_jax(devices8, hot, keys, slack, n, cap):
    """The probe's quantized slot (rows, at most the structural slot)
    equals the JAX package's ``_probe_slot_rows`` on the same data."""
    cols = _skewed(max(n, 1), 1, hot)
    if n == 0:
        cols = {k: v[:0] for k, v in cols.items()}
    t, j = _ctx(), JContext(config=JJobConfig(exchange_probe_min_mb=0))
    tpd = t.from_columns(cols, capacity=cap).node.data
    jpd = j.from_columns(cols, capacity=cap).node.data
    run = _run(t)
    got = t.executor._probe_slot_rows(tpd, list(keys), slack, run)
    want = j.executor._probe_slot_rows(jpd, list(keys), slack)
    assert got == want
    assert t.executor.probes_run == run.probes_run == 1
    # probing the same live tensors again reads nothing
    assert t.executor._probe_slot_rows(tpd, list(keys), slack, run) == got
    assert t.executor.probes_run == run.probes_run == 1


def _hash_query(ctx, cols, where=None):
    d = ctx.from_columns(cols, capacity=600)
    if where is not None:
        d = d.where(where)
    return d.hash_partition(["k"])


def test_sources_in_order(devices8):
    """A pure hash leg probes on its first run and takes the feedback on
    the next run of the same stage; a leg with ops ships the slack first
    and the feedback of its own stage after; no probe without enough
    MB."""
    cols = _skewed(4000, 2, 0.0)
    t = _ctx()
    out = _hash_query(t, cols).collect()
    st = _log(t)
    assert st["slot_source"] == [["probe"]] and st["probes"] == 1
    assert st["slot_rows"][0][0] < -(-2 * 600 // P)
    assert _rows(out) == _rows(cols)
    _hash_query(t, cols).collect()
    st = _log(t)
    assert st["slot_source"] == [["feedback"]] and st["probes"] == 0

    def keep(c):
        return c["v"] > -1.0

    _hash_query(t, cols, keep).collect()
    assert _log(t)["slot_source"] == [["slack"]]
    assert _log(t)["slot_rows"] == [[-(-2 * 600 // P)]]
    _hash_query(t, cols, keep).collect()
    assert _log(t)["slot_source"] == [["feedback"]]
    # a fresh predicate is another stage: no feedback of its own
    _hash_query(t, cols, lambda c: c["v"] > -1.0).collect()
    assert _log(t)["slot_source"] == [["slack"]]
    big = _ctx(mb=8.0)
    _hash_query(big, cols).collect()
    assert _log(big)["slot_source"] == [["slack"]]


def test_no_hints_salted_or_one_partition(devices8):
    """A salted attempt and a one-partition executor ship the structural
    slack on every leg; a broadcast leg has no slot."""
    t = _ctx()
    pd = t.from_columns(_skewed(800, 3, 0.5), capacity=200).node.data
    stage = Stage(0, [Leg(("source", pd), [], Exchange("hash", ("k",), 200)),
                      Leg(("source", pd), [], Exchange("broadcast",
                                                        out_capacity=1600))])
    assert t.executor._slot_hints(stage, [pd, pd], 2, True,
                                  _run(t)) == [(None, "slack"), (None, None)]
    assert t.executor._slot_hints(stage, [pd, pd], 2, False,
                                  _run(t))[0][1] == "probe"
    one = _ctx(nparts=1)
    pd1 = one.from_columns(_skewed(800, 3, 0.5)).node.data
    stage1 = Stage(0, [Leg(("source", pd1), [],
                           Exchange("hash", ("k",), 800))])
    assert one.executor._slot_hints(stage1, [pd1], 2, False,
                                    _run(one)) == [(None, "slack")]
    assert one.executor.probes_run == 0


def test_salted_join_attempt_ships_slack(devices8):
    """A 90 %-hot join with the probe on: the first attempt's two pure
    legs probe, the salted retry ships the slack on both, and the rows
    equal the JAX package's."""
    rng = np.random.RandomState(4)
    n = 4000
    left = {"k": np.where(rng.rand(n) < 0.9, 0,
                          rng.randint(1, 500, n)).astype(np.int32),
            "a": np.arange(n, dtype=np.int32)}
    right = {"k": np.arange(500, dtype=np.int32),
             "b": (np.arange(500) * 3).astype(np.int32)}

    def q(c):
        j = c.from_columns(left).join(c.from_columns(right), ["k"])
        return j.group_by(["b"], {"n": ("count", None)})

    t = _ctx()
    got = q(t).collect()
    st = _log(t, "join")
    assert st["salted"] and st["attempts"] == 2
    assert st["slot_source"] == [["probe", "probe"], ["slack", "slack"]]
    assert st["probes"] == 2
    assert _rows(got) == _rows(q(JContext()).collect())


def test_stale_feedback_retries_for_slack(devices8):
    """The feedback of a run over evenly spread keys meets keys that go
    to two destinations: the measured slot falls short, the stage retries
    with the newer measurement and every row arrives."""
    rng = np.random.RandomState(5)
    n = 320
    even = {"k": rng.randint(0, 10_000, n).astype(np.int32),
            "v": np.arange(n, dtype=np.int32)}
    t = _ctx()
    t.from_columns(even, capacity=256).hash_partition(["k"]).collect()
    first = _log(t)
    assert first["slot_source"] == [["probe"]]
    # two keys landing on two different destinations
    lo = hash_columns([torch.arange(64, dtype=torch.int32)])[1] % P
    a, b = [int(np.flatnonzero(lo.numpy() == d)[0]) for d in (1, 5)]
    skew = {"k": np.where(np.arange(n) % 2 == 0, a, b).astype(np.int32),
            "v": np.arange(n, dtype=np.int32)}
    out = t.from_columns(skew, capacity=256).hash_partition(["k"]).collect()
    st = _log(t)
    assert st["slot_source"] == [["feedback"], ["feedback"]]
    assert st["attempts"] == 2 and st["scale"] == 1
    assert st["slot_rows"][0][0] < 20 <= st["slot_rows"][1][0]
    assert _rows(out) == _rows(skew)


def test_probe_disabled_ships_structural_slot(devices8):
    cols = _skewed(4000, 6, 0.0)
    t = _ctx(mb=-1)
    for _ in range(2):
        out = _hash_query(t, cols).collect()
        st = _log(t)
        assert st["slot_source"] == [["slack"]]
        assert st["slot_rows"] == [[-(-2 * 600 // P)]]
        assert st["probes"] == 0
    assert _rows(out) == _rows(cols)
    with pytest.raises(ValueError, match="exchange_probe_min_mb"):
        JobConfig(exchange_probe_min_mb=-2)
