"""The port's lineage recovery and deferred settle (``exec/recovery.Run``)
against the JAX package's ``Run`` on its 8-device CPU mesh, with the same
numpy inputs (mirrors ``tests/test_store_recovery.py``'s replay cases).

Plans: ``where`` -> ``group_by`` (no retry), a retrying ``order_by``
followed by a ``group_by`` (an exchange stage that overflows, and a
dependent), and a 90 %-hot join that salts at its second attempt.
Tolerance: none; rows compare as multisets of whole rows (int32, float32
max, strings)."""

import collections

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.exec.data import pdata_to_host as jpdata_to_host
from dryad_tpu.exec.executor import CapacityError as JCapacityError
from dryad_tpu.exec.recovery import FailureBudgetExceeded as JBudget
from dryad_tpu.exec.recovery import Run as JRun
from dryad_tpu.plan.planner import plan_query as jplan_query
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu.utils.events import EventLog as JEventLog
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.exec.data import pdata_to_host
from dryad_tpu_torch.exec.executor import CapacityError
from dryad_tpu_torch.exec.recovery import FailureBudgetExceeded, Run
from dryad_tpu_torch.plan.planner import plan_query
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8


def _data(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, 12, n).astype(np.int32),
            "v": rng.randint(0, 1000, n).astype(np.int32),
            "f": rng.rand(n).astype(np.float32),
            "s": ["w%d" % i for i in rng.randint(0, 40, n)]}


def _skewed(n=20_000, seed=0):
    """90 % of the left keys 0, the rest uniform over [1, 1000)."""
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < 0.9, 0,
                 rng.integers(1, 1000, n)).astype(np.int32)
    return {"k": k, "v": rng.integers(0, 10, n).astype(np.int32)}


def _where_groupby(ctx):
    return ctx.from_columns(_data()).where(lambda c: c["v"] > 300).group_by(
        ["s"], {"n": ("count", None), "t": ("sum", "v"), "m": ("max", "f")})


def _order_by(ctx):
    # 12 primary keys: a tie run overflows one destination's receive
    # capacity; the group_by stage is computed from the order_by's output
    return ctx.from_columns(_data()).order_by(
        [("k", False), ("v", True)]).group_by(
        ["v"], {"n": ("count", None), "kk": ("max", "k")})


def _skew_join(ctx):
    right = ctx.from_columns({"k": np.arange(1000, dtype=np.int32),
                              "w": np.arange(1000, dtype=np.int32) * 3})
    return ctx.from_columns(_skewed()).join(right, ["k"], ["k"])


PLANS = {"where_groupby": _where_groupby, "order_by": _order_by,
         "skew_join": _skew_join}


def _rows(table):
    cols = sorted(table)
    vals = [list(table[c]) if isinstance(table[c], list)
            else np.asarray(table[c]).tolist() for c in cols]
    return collections.Counter(zip(*vals))


def _tctx(**cfg):
    return TContext(device="cpu", nparts=P, config=JobConfig(**cfg))


def _truns(plan, **cfg):
    """(port Run over the plan, its graph, its context)."""
    ctx = _tctx(**cfg)
    graph = plan_query(PLANS[plan](ctx).node, P)
    return Run(ctx.executor, graph), graph, ctx


def _jrun(plan, **cfg):
    ctx = JContext(config=JJobConfig(**cfg))
    graph = jplan_query(PLANS[plan](ctx).node, ctx.nparts)
    return JRun(ctx.executor, graph), graph, ctx


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_run_matches_jax(devices8, plan):
    run, _, _ = _truns(plan)
    jrun, _, _ = _jrun(plan)
    assert _rows(pdata_to_host(run.output())) == \
        _rows(jpdata_to_host(jrun.output()))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_replay_after_invalidating_every_stage(devices8, plan):
    """Every stage lost, then the output asked for again: the same rows
    bit for bit (the port's own first output, and the JAX package's after
    the same invalidations)."""
    run, graph, _ = _truns(plan)
    first = pdata_to_host(run.output())
    jrun, _, _ = _jrun(plan)
    jrun.output()
    for sid in range(len(graph.stages)):
        run.invalidate(sid)
        jrun.invalidate(sid)
    again = pdata_to_host(run.output())
    assert run.failures == len(graph.stages)
    assert sorted(again) == sorted(first)
    for k in first:
        if isinstance(first[k], list):
            assert again[k] == first[k]
        else:
            assert np.asarray(again[k]).tobytes() == \
                np.asarray(first[k]).tobytes()
    assert _rows(again) == _rows(jpdata_to_host(jrun.output()))


def test_failure_budget_raises_at_the_same_invalidation(devices8):
    seen = []
    for make, budget_error in ((_truns, FailureBudgetExceeded),
                               (_jrun, JBudget)):
        run, graph, _ = make("where_groupby")
        run.failure_budget = 2
        run.output()
        n = 0
        with pytest.raises(budget_error, match="3 failures > budget 2"):
            for n in range(1, 5):
                run.invalidate(graph.out_stage)
                run.output()
        seen.append(n)
    assert seen == [3, 3]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_deferred_and_synchronous_rows_equal(devices8, plan):
    deferred = PLANS[plan](_tctx()).collect()
    sync = PLANS[plan](_tctx(deferred_needs=False)).collect()
    assert _rows(deferred) == _rows(sync)


def test_one_host_read_per_job_when_deferred(devices8):
    ctx = _tctx()
    _where_groupby(ctx).collect()
    log = ctx.executor.stage_log
    assert ctx.executor.host_reads == 1
    assert all(st["attempts"] == 1 and not st["settle_replayed"]
               for st in log)
    _where_groupby(ctx).collect()
    assert ctx.executor.host_reads == 2


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_one_host_read_per_attempt_when_synchronous(devices8, plan):
    ctx = _tctx(deferred_needs=False)
    PLANS[plan](ctx).collect()
    log = ctx.executor.stage_log
    assert ctx.executor.host_reads == sum(st["attempts"] for st in log)
    assert not any(st["settle_replayed"] for st in log)


@pytest.mark.parametrize("plan", ["order_by", "skew_join"])
def test_settle_replays_the_same_stages_as_jax(devices8, plan):
    """Where the two packages plan alike (``explain()`` equal), the
    settle replays the same stage ids; the overflowed stage and its
    dependents count one attempt more, in one stage_log entry each."""
    tlog, jlog = EventLog(), JEventLog()
    t = TContext(device="cpu", nparts=P, event_log=tlog)
    j = JContext(event_log=jlog)
    assert PLANS[plan](t).explain() == PLANS[plan](j).explain()
    assert _rows(PLANS[plan](t).collect()) == \
        _rows(PLANS[plan](j).collect())
    (rep,) = tlog.of_type("settle_replay")
    (jrep,) = jlog.of_type("settle_replay")
    assert rep["stages"] == jrep["stages"]
    log = {st["stage"]: st for st in t.executor.stage_log}
    assert len(log) == len(t.executor.stage_log)
    for sid, st in log.items():
        replayed = sid in rep["stages"]
        assert st["settle_replayed"] == replayed
        assert st["attempts"] == 1 + replayed
    # the deferred read, then one read per replayed attempt
    assert t.executor.host_reads == 1 + len(rep["stages"])
    if plan == "skew_join":
        (join,) = [st for st in log.values() if st["label"] == "join"]
        assert join["salted"] and join["salted_attempts"] == 1


@pytest.mark.parametrize("deferred", [True, False])
def test_capacity_error_without_retries(devices8, deferred):
    """``max_capacity_retries=0`` surfaces the order_by's overflow as a
    CapacityError (at the settle when deferred), as the JAX package
    does."""
    ctx = _tctx(max_capacity_retries=0, deferred_needs=deferred)
    with pytest.raises(CapacityError, match=(
            "deferred settle" if deferred else "0 capacity retries")):
        _order_by(ctx).collect()
    with pytest.raises(JCapacityError):
        _order_by(JContext(config=JJobConfig(
            max_capacity_retries=0, deferred_needs=deferred))).collect()


@pytest.mark.parametrize("cap", [500, 700])
def test_with_capacity_after_a_retrying_stage_matches_jax(devices8, cap):
    """A retrying order_by followed by a with_capacity stage: the
    dependent sees the truncated output before the settle.  At 500 rows
    a partition the with_capacity stage cannot hold its input (an
    overflow no scale fixes): CapacityError in both packages, deferred or
    not; at 700 both return every row."""
    d = _data(n=4000, seed=11)

    def q(ctx):
        return ctx.from_columns(d).order_by([("k", False)]).with_capacity(
            cap)

    outcomes = []
    for ctx in (JContext(), _tctx(), _tctx(deferred_needs=False)):
        try:
            outcomes.append(len(q(ctx).collect()["k"]))
        except (CapacityError, JCapacityError) as e:
            outcomes.append("overflowed a fixed capacity" in str(e))
    assert outcomes == ([True] * 3 if cap == 500 else [4000] * 3)


def test_job_tag_on_every_event(devices8):
    log = EventLog()
    ctx = TContext(device="cpu", nparts=P, event_log=log)
    graph = plan_query(_order_by(ctx).node, P)
    ctx.executor.run(graph, job="job-7")
    kinds = {e["event"] for e in log.events}
    assert {"stage_done", "settle_replay", "job_done"} <= kinds
    assert all(e["job"] == "job-7" for e in log.events)
    assert all(st["job"] == "job-7" for st in ctx.executor.stage_log)
    # an explicit sink wins over the executor's, untagged without a job
    other = EventLog()
    ctx.executor.run(graph, event_log=other)
    assert other.of_type("job_done") and "job" not in other.events[-1]
    assert len(log.of_type("job_done")) == 1


def test_slot_feedback_noted_at_the_settle(devices8):
    """Under deferral the measured send slots are fed back at the settle,
    before the replay: the replayed order_by ships the feedback slot, and
    a second run of the same plan ships it from its first attempt."""
    ctx = _tctx()
    graph = plan_query(_order_by(ctx).node, P)
    ctx.executor.run(graph)
    (ob,) = [st for st in ctx.executor.stage_log
             if st["label"] == "orderby"]
    assert ob["slot_source"] == [["slack"], ["feedback"]]
    ctx.executor.run(graph)
    (ob,) = [st for st in ctx.executor.stage_log
             if st["label"] == "orderby"]
    assert ob["attempts"] == 1 and ob["slot_source"] == [["feedback"]]


def test_replayed_dependents_run_one_attempt_more(devices8):
    """PageRank at 2,000 nodes retries a join in a superstep: the settle
    re-runs the stages computed from it, each exactly once more than the
    synchronous form runs it (a slot measured on the truncated input is
    not fed back, so the replay does not fall short for it), and every
    other stage runs as often as in the synchronous form."""
    from dryad_tpu_torch.apps import pagerank as tpr
    n = 2000
    edges = tpr.gen_graph(n, 10 * n, seed=0)
    attempts = {}
    for form, deferred in (("deferred", True), ("sync", False)):
        ctx = _tctx(deferred_needs=deferred)
        logs = []
        run = ctx.executor.run

        def logged(graph, bindings=None, **kw):
            out = run(graph, bindings, **kw)
            logs.extend(ctx.executor.stage_log)
            return out

        ctx.executor.run = logged
        tpr.pagerank(ctx, edges, n, n_iters=10)
        attempts[form] = [(st["label"], st["attempts"],
                           st["settle_replayed"]) for st in logs]
    extra = [(d[0], d[1] - s[1], d[2]) for d, s in
             zip(attempts["deferred"], attempts["sync"])]
    assert [x[0] for x in attempts["deferred"]] == \
        [x[0] for x in attempts["sync"]]
    assert all(x in (0, 1) and (x == 0 or replayed)
               for _, x, replayed in extra), extra
    assert sum(x for _, x, _ in extra) >= 2


def test_chip_smoke_phase11_rehearsal(devices8, monkeypatch, tmp_path):
    """chip_smoke.py's phase 11 on the CPU at small sizes (pagerank at
    1,000 nodes and 3 iterations, TeraSort at 50,000 records, 120,000 lineitems, 2,000
    lines), every kernel's plain version bumping its launch counter as
    the kernel does on the card, and every call held: each check of the
    phase passes, and every one of the five kernels is held."""
    import types

    import torch

    import chip_smoke
    from dryad_tpu_torch.apps import pagerank as tpr
    from dryad_tpu_torch.apps import terasort as tts
    from dryad_tpu_torch.apps import wordcount as twc
    from dryad_tpu_torch.ops import hopper_kernels as hk
    from test_torch_pagerank import _counting_plain

    _counting_plain(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: None)
    monkeypatch.setattr(chip_smoke, "profile_path", lambda *a, **k: {
        "wall_s": 1.0, "device_ms": None})
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: TContext(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    monkeypatch.setattr(chip_smoke, "PR_ITERS", 3)
    n = 1000
    edges = tpr.gen_graph(n, 10 * n, seed=0)
    forms = chip_smoke.pagerank_forms(port, hk, tpr, edges, n,
                                      str(tmp_path), held)
    runs_ = forms["deferred"]["executor_runs"]
    assert runs_ == forms["sync"]["executor_runs"] == 3 + 3
    assert forms["sync"]["need_reads_per_run"] == \
        forms["sync"]["stage_attempts"] > runs_
    assert runs_ <= forms["deferred"]["need_reads_per_run"] < \
        forms["sync"]["need_reads_per_run"]
    li, orders, _ = chip_smoke.tpch_tables(120_000)
    recs = tts.gen_records(50_000, seed=0)
    settle = chip_smoke.settle_runs(port, hk, tts, (recs, 10), li, orders,
                                    held)
    assert settle["terasort1m"]["replayed"] == [("orderby", 2)]
    assert ("join", 2) in settle["skewjoin6m"]["replayed"]
    lineage = chip_smoke.lineage_run(port, hk, li, orders, held)
    assert lineage["failures"] == lineage["stages"]
    spill = chip_smoke.spill_runs(port, hk, li, str(tmp_path), held)
    assert spill["spilled"] == spill["stages"] and spill["read_bytes"] > 0
    store = chip_smoke.store_round_trips(port, hk, li, orders,
                                         str(tmp_path), held)
    assert store["orders_gzip_bytes"] < store["orders_raw_bytes"]
    lines = chip_smoke.bench_corpus(2000)
    text = chip_smoke.read_text_run(port, hk, twc, lines,
                                    chip_smoke.oracle(lines),
                                    str(tmp_path), held)
    assert text["words"] == 12
    assert {k for _, errs in runs.values() for k in errs} == \
        set(chip_smoke.TPU_KERNEL)
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
