"""The port's durable job service (``dryad_tpu_torch/service/durable``)
against the JAX package's, on the CPU (mirrors ``tests/test_durable.py``).

The journal: the same call sequence gives the same ``ReplayState`` in
both packages (live and terminal jobs, tenant ledgers, standing
registrations, epochs); a journal written by either package replays to
that state in the other; a torn tail is truncated, garbage before it and
a format-version mismatch are refused with the same DTA914; compaction
never folds a record twice.  Through the port's daemon
(``JobService(device="cpu")``): crash recovery re-admits queued jobs in
their original ``seq`` order with each tenant charged once, a job that
cannot be rebuilt fails with forensics, and a handoff pauses a SQL job
after its first settled stage and the successor resumes it from spill
(``stage_restored``) with the rows of an uninterrupted run.

Tolerance: none (integer columns; ledgers compare as floats written and
read by the same JSON)."""

import json
import os
import shutil
import threading
from collections import Counter

import numpy as np
import pytest

from dryad_tpu.service.durable import Journal as JJournal
from dryad_tpu.service.durable import JournalError as JJournalError
from dryad_tpu_torch import Context
from dryad_tpu_torch import sql
from dryad_tpu_torch.service import APPS, JobService, ServiceConfig
from dryad_tpu_torch.service.durable import (JOURNAL_VERSION, Journal,
                                             JournalError, ReplayState)
from dryad_tpu_torch.service.durable.journal import TERMINAL_STATES
from dryad_tpu_torch.utils.atomic import atomic_write_json
from tests.torch_threads import one_torch_thread  # noqa: F401


def _spec(jid, tenant="t", seq=1, kind="app", params=None):
    return {"id": jid, "tenant": tenant, "app": "wordcount",
            "seq": seq, "priority": 0, "n_tasks": 1, "kind": kind,
            "params": params or {"n_lines": 8}, "recoverable": True,
            "submitted_ts": 0.0}


def _script(j) -> None:
    """One journal call sequence: two epochs' worth of admissions,
    dispatches, charges, terminals (a duplicate among them), a
    rejection, standing registrations and a cancel, a handoff mark."""
    j.job_admitted(_spec("a-1", tenant="alice", seq=1))
    j.job_queued("a-1", 1)
    j.job_dispatched("a-1")
    j.tenant_charge("alice", 1.5, ok=True)
    j.job_terminal("a-1", "done", wall_s=1.5)
    j.job_terminal("a-1", "failed", error="late")
    j.job_admitted(_spec("b-2", tenant="bob", seq=2))
    j.job_queued("b-2", 2)
    j.job_admitted(_spec("c-3", tenant="bob", seq=3))
    j.job_dispatched("c-3")
    j.tenant_charge("bob", 0.25, ok=False)
    j.job_admitted(_spec("r-4", tenant="carol", seq=4))
    j.job_terminal("r-4", "rejected", error="DTA911")
    j.standing_registered({"id": "carol-standing-1", "tenant": "carol",
                           "query": "SELECT ..."})
    j.standing_registered({"id": "carol-standing-2", "tenant": "carol",
                           "query": "SELECT ..."})
    j.standing_cancelled("carol-standing-1")
    j.handoff_ready()


def _state(st) -> dict:
    return {"jobs": st.jobs, "tenants": st.tenants,
            "standing": st.standing, "seq": st.seq, "clean": st.clean,
            "epochs": st.epochs, "dup": st.dup_terminals,
            "live": [e["id"] for e in st.live_jobs()],
            "handoff": st.handoff is not None}


def _replayed(cls, d) -> dict:
    j = cls(d, fsync=False)
    try:
        return _state(j.recovered)
    finally:
        j.close(clean=False)


@pytest.mark.parametrize("clean", [True, False])
def test_replay_state_matches_jax_after_the_same_calls(tmp_path, clean):
    states = {}
    for name, cls in (("port", Journal), ("jax", JJournal)):
        d = str(tmp_path / name)
        j = cls(d, fsync=False)
        _script(j)
        j.close(clean=clean)
        states[name] = _replayed(cls, d)
    assert states["port"] == states["jax"]
    st = states["port"]
    assert st["live"] == ["b-2", "c-3"] and st["dup"] == ["a-1"]
    assert st["jobs"]["r-4"]["phase"] == "rejected"
    assert list(st["standing"]) == ["carol-standing-2"]
    assert st["tenants"]["bob"] == {"used_slot_s": 0.25, "failures": 1}


@pytest.mark.parametrize("writer,reader", [(JJournal, Journal),
                                           (Journal, JJournal)])
def test_a_journal_replays_the_same_in_the_other_package(tmp_path, writer,
                                                         reader):
    d = str(tmp_path / "durable")
    j = writer(d, fsync=False, compact_every=8)
    _script(j)
    j.close(clean=False)
    assert os.path.exists(j.ckpt_path)           # compaction ran too
    # each replay opens (and so appends to) a copy of its own
    shutil.copytree(d, d + "-copy")
    assert _replayed(reader, d) == _replayed(writer, d + "-copy")


def test_compaction_never_double_folds(tmp_path):
    d = str(tmp_path / "durable")
    j = Journal(d, fsync=False, compact_every=8)
    for i in range(1, 30):
        j.job_admitted(_spec(f"j-{i}", tenant="alice", seq=i))
        j.tenant_charge("alice", 0.25)
        j.job_terminal(f"j-{i}", "done")
    assert os.path.exists(j.ckpt_path)
    j.close(clean=True)
    st = Journal(d, fsync=False).recovered
    assert st.tenants["alice"]["used_slot_s"] == pytest.approx(29 * 0.25)
    assert sum(1 for e in st.jobs.values() if e["phase"] == "done") == 29
    assert not st.live_jobs() and not st.dup_terminals


def _write_one(cls, d):
    j = cls(d, fsync=False)
    j.job_admitted(_spec("a-1"))
    j.job_queued("a-1", 1)
    j.close(clean=False, release_lock=False)
    return j.path


@pytest.mark.parametrize("cut", ["torn", "chopped"])
def test_a_torn_tail_is_truncated_in_both_packages(tmp_path, cut):
    for name, cls in (("port", Journal), ("jax", JJournal)):
        d = str(tmp_path / name)
        path = _write_one(cls, d)
        with open(path, "ab") as f:
            if cut == "torn":
                f.write(b'{"rec": "job_queued", "id": "x-9", "n')
        if cut == "chopped":
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size - 10)
        j = cls(d, fsync=False)
        assert j.was_torn
        phase = j.recovered.jobs["a-1"]["phase"]
        assert phase == ("queued" if cut == "torn" else "admitted")
        j.close(clean=True)
        again = cls(d, fsync=False)
        assert not again.was_torn and again.was_clean
        again.close()


@pytest.mark.parametrize("fault", ["garbage", "checkpoint_version",
                                   "record_version"])
def test_corruption_is_refused_with_dta914_in_both(tmp_path, fault):
    for name, cls, err in (("port", Journal, JournalError),
                           ("jax", JJournal, JJournalError)):
        d = str(tmp_path / name)
        path = _write_one(cls, d)
        if fault == "garbage":
            with open(path) as f:
                lines = f.readlines()
            lines.insert(1, "NOT JSON AT ALL\n")
            with open(path, "w") as f:
                f.writelines(lines)
        elif fault == "checkpoint_version":
            atomic_write_json(os.path.join(d, "checkpoint.json"),
                              {"journal_version": JOURNAL_VERSION + 99})
        else:
            with open(path, "a") as f:
                f.write(json.dumps({"rec": "open", "n": 99,
                                    "journal_version": 7}) + "\n")
        with pytest.raises(err) as ei:
            cls(d, fsync=False)
        assert ei.value.code == "DTA914"


def test_replay_exactly_once_and_rejected_never_resurrects():
    st = ReplayState()
    st.fold({"rec": "job_admitted", "n": 1, "spec": _spec("a-1")})
    st.fold({"rec": "job_terminal", "n": 2, "id": "a-1", "state": "done"})
    st.fold({"rec": "job_terminal", "n": 3, "id": "a-1",
             "state": "failed"})
    assert st.dup_terminals == ["a-1"]
    assert st.jobs["a-1"]["phase"] == "done"
    st.fold({"rec": "job_admitted", "n": 4, "spec": _spec("r-2", seq=2)})
    st.fold({"rec": "job_terminal", "n": 5, "id": "r-2",
             "state": "rejected"})
    assert "rejected" in TERMINAL_STATES and not st.live_jobs()


# -- crash recovery and handoff through the port's daemon --------------------


def _wc_oracle(params):
    c = Counter()
    for t in APPS["wordcount"].make_tasks(dict(params), 4):
        for line in t["line"]:
            c.update(line.split())
    return dict(sorted(c.items()))


def _cfg(d, **kw):
    return ServiceConfig(service_dir=d, slots=1, journal_fsync=False, **kw)


def _charges(d) -> Counter:
    with open(os.path.join(d, "durable", "journal.jsonl")) as f:
        return Counter(r["tenant"] for r in map(json.loads, f)
                       if r.get("rec") == "tenant_charge")


def hold_after_first(svc):
    """Every job of ``svc`` but the first waits, as its run starts, until
    its pause is set (``crash()`` sets it): no job but the first can
    finish before the crash, however the threads are scheduled."""
    durable_kw, first = svc._durable_run_kw, []

    def kw(job):
        if first and first[0] != job.id:
            job.pause.wait(60)
        first[:] = first or [job.id]
        return durable_kw(job)

    svc._durable_run_kw = kw


def test_crash_readmits_in_seq_order_and_charges_each_tenant_once(
        tmp_path):
    """Four jobs of two tenants on one slot; ``crash()`` once the first
    is done (the others held before they run).  The successor resumes or re-admits the other three in
    their original ``seq`` order, restores the ledgers as floors (not
    doubled), every job ends with the oracle's counts, and the journal
    holds exactly one charge per job."""
    d = str(tmp_path / "svc")
    params = [{"n_lines": 64, "seed": s} for s in range(4)]
    tenants = ["alice", "bob", "alice", "bob"]
    svc = JobService(_cfg(d), device="cpu")
    hold_after_first(svc)
    jids = [svc.submit("wordcount", p, tenant=t)
            for p, t in zip(params, tenants)]
    assert svc.wait(jids[0], timeout=120)["state"] == "done"
    svc.crash()
    before = svc.admission.shares()
    svc2 = JobService(_cfg(d), device="cpu")
    try:
        rec = svc2.recovery
        assert rec["failed"] == 0 and not rec["clean"]
        assert rec["resumed"] + rec["readmitted"] == 3
        back = [e for e in svc2.log.events
                if e["event"] in ("job_resumed", "job_readmitted")]
        assert [e["job"] for e in back] == jids[1:]
        assert [e["seq"] for e in back] == sorted(e["seq"] for e in back)
        assert svc2.status(jids[0])["archived"]
        restored = svc2.admission.shares()
        assert restored["alice"][0] >= before["alice"][0] > 0
        for jid, p in zip(jids, params):
            row = svc2.wait(jid, timeout=120)
            assert row["state"] == "done", row.get("error")
            if jid != jids[0]:
                assert row["result"]["words"] == _wc_oracle(p)
    finally:
        svc2.close()
    assert _charges(d) == {"alice": 2, "bob": 2}
    st = Journal(os.path.join(d, "durable"), fsync=False).recovered
    assert not st.dup_terminals and not st.live_jobs()


def test_unrecoverable_job_fails_with_forensics(tmp_path):
    d = str(tmp_path / "svc")
    gate = threading.Event()
    svc = JobService(_cfg(d), device="cpu")
    blocker = svc.submit_callable(lambda env: gate.wait(30), tenant="x")
    jb = svc.submit("wordcount", {"n_lines": 64}, tenant="alice")
    jc = svc.submit_callable(lambda env: {"x": 1}, tenant="bob")
    gate.set()
    svc.crash()
    svc2 = JobService(_cfg(d), device="cpu")
    try:
        row = svc2.status(jc)
        assert row["state"] == "failed"
        assert "lost across daemon restart" in row["error"]
        assert "job dir" in row["error"]
        assert svc2.wait(jb, timeout=120)["state"] == "done"
        assert svc2.status(blocker)["state"] in ("done", "failed")
    finally:
        svc2.close()


def _join_catalog(root):
    """Three stores: the 3-way join lowers to several stages, so the
    handoff has interior stage boundaries."""
    ctx = Context(device="cpu", nparts=8)
    n, keys = 6000, 64
    ctx.from_columns({"k": (np.arange(n) % keys).astype(np.int32),
                      "v": np.arange(n, dtype=np.int32)}
                     ).to_store(os.path.join(root, "a"))
    ctx.from_columns({"k": np.arange(keys, dtype=np.int32),
                      "w": (np.arange(keys) * 3).astype(np.int32)}
                     ).to_store(os.path.join(root, "b"))
    ctx.from_columns({"k": np.arange(keys, dtype=np.int32),
                      "u": (np.arange(keys) * 7).astype(np.int32)}
                     ).to_store(os.path.join(root, "c"))
    cat = sql.Catalog()
    for name in ("a", "b", "c"):
        cat.register_store(name, os.path.join(root, name))
    q = ("SELECT a.k, SUM(a.v + b.w + c.u) AS s FROM a "
         "JOIN b ON a.k = b.k JOIN c ON a.k = c.k "
         "GROUP BY a.k ORDER BY s DESC LIMIT 16")
    return cat, q


def pause_after_first_stage(svc):
    """Make ``svc``'s jobs stop at their first settled stage until their
    pause is set: returns an Event set once a job's first stage is
    spilled and checkpointed (the handoff then lands right there)."""
    settled = threading.Event()
    durable_kw = svc._durable_run_kw

    def kw(job):
        out = durable_kw(job)
        ckpt = out["checkpoint"]

        def hook(run, sid):
            ckpt(run, sid)
            settled.set()
            job.pause.wait(60)
        out["checkpoint"] = hook
        return out

    svc._durable_run_kw = kw
    return settled


def test_handoff_resumes_from_spill_with_stage_restored(tmp_path):
    cat, q = _join_catalog(str(tmp_path))
    d = str(tmp_path / "svc")
    svc = JobService(_cfg(d, durable_spill=True), device="cpu",
                     catalog=cat)
    settled = pause_after_first_stage(svc)
    j1 = svc.submit_sql(q, tenant="alice")
    assert settled.wait(60)
    h = svc.handoff()
    assert h["paused"] == 1
    with pytest.raises(Exception):
        svc.submit_sql(q, tenant="alice")
    ck = json.load(open(os.path.join(svc.jobs[j1].dir, "checkpoint.json")))
    svc2 = JobService(_cfg(d, durable_spill=True), device="cpu",
                      catalog=cat)
    try:
        assert svc2.recovery["resumed"] == 1
        row = svc2.wait(j1, timeout=120)
        assert row["state"] == "done", row.get("error")
        fresh = svc2.wait(svc2.submit_sql(q, tenant="bob"), timeout=120)
        assert row["result"] == fresh["result"]
        ev = svc2.jobs[j1].log.events
        restored = {e["stage"] for e in ev
                    if e["event"] == "stage_restored"}
        computed = {e["stage"] for e in ev if e["event"] == "stage_done"}
        assert restored == set(ck["settled"]) and len(restored) == 1
        assert computed and not (computed & restored)
        kinds = [e["event"] for e in svc2.log.events]
        assert "handoff_adopted" in kinds and "journal_replay" in kinds
    finally:
        svc2.close()
