"""The port's per-tenant SLO tracking (``dryad_tpu_torch/obs/slo.py``)
against the JAX package's ``obs/slo.py`` with the same scripted calls,
and its wiring into the port's job service on the CPU: the ``/slo``
endpoint and the once-per-transition ``slo_breach``, the live progress
gauge, the long-poll and SSE streams of two concurrent jobs, and the
level-0 no-op contract (mirrors ``tests/test_slo.py``).

Tolerance: none; attainment and burn rates compare exactly (the same
Python float arithmetic in both packages)."""

import itertools
import tempfile
import threading
import time

import pytest

from dryad_tpu.obs.slo import SloObjective as JObjective
from dryad_tpu.obs.slo import SloTracker as JTracker
from dryad_tpu.obs.slo import burn_rate as jburn_rate
from dryad_tpu.obs.slo import slo_from_events as jslo_from_events
from dryad_tpu.service.job import _JobLog as JJobLog
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.obs.slo import (SloObjective, SloTracker, burn_rate,
                                     slo_from_events)
from dryad_tpu_torch.service.job import _JobLog
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _detach_tracer():
    yield
    trace.install(None)


@pytest.mark.parametrize("kw", [
    {"latency_s": 2.0, "target": 0.9}, {"target": 0.9}, {},
    {"target": 1.0}, {"target": -0.1}, {"target": 0.5, "window": 0},
    {"target": 0.5, "latency_s": -1}])
def test_objective_validation_and_verdicts_match_jax(kw):
    try:
        want = JObjective(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            SloObjective(**kw)
        return
    got = SloObjective(**kw)
    assert got.active == want.active
    for ok, wall in itertools.product((True, False), (None, 0.1, 1.5,
                                                      2.5)):
        assert got.good(ok, wall) == want.good(ok, wall)


def test_burn_rate_matches_jax_on_a_grid():
    for att, tgt in itertools.product((0.0, 0.5, 0.9, 0.98, 0.99, 1.0),
                                      (0.0, 0.5, 0.9, 0.99)):
        assert burn_rate(att, tgt) == jburn_rate(att, tgt)
    assert burn_rate(0.98, 0.99) == pytest.approx(2.0)


def test_tracker_rows_match_jax_over_a_scripted_stream():
    """The same terminal jobs of three tenants (one without an SLO, one
    whose window rolls) fold into equal rows and snapshots after every
    record."""
    objs = {"acme": (0.5, 0.0, 4), "slow": (0.9, 1.0, 8),
            "free": (0.0, 0.0, 64)}
    tr = SloTracker(lambda t: SloObjective(objs[t][1], objs[t][0],
                                           objs[t][2]))
    jt = JTracker(lambda t: JObjective(objs[t][1], objs[t][0], objs[t][2]))
    script = [("acme", True, 0.1), ("acme", True, 0.1),
              ("acme", False, 0.1), ("slow", True, 0.5),
              ("free", True, 0.1), ("acme", False, 0.1),
              ("slow", True, 2.0), ("acme", False, 0.1),
              ("slow", False, None), ("acme", True, 0.2)]
    for tenant, ok, wall in script:
        assert tr.record(tenant, ok, wall) == jt.record(tenant, ok, wall)
        assert tr.snapshot() == jt.snapshot()
    assert tr.row("acme")["breaching"] is True
    assert tr.row("free") is None and "free" not in tr.snapshot()


def test_slo_from_events_and_the_job_log_stamp_match_jax():
    """Rows derived from recorded events equal the JAX package's, and a
    job log stamps its job and tenant on every record exactly as the JAX
    ``_JobLog`` does (the Run's ``job_done`` carries no tenant)."""
    obj = (1.0, 0.5, 8)
    events = [{"event": "job_done", "tenant": "a", "wall_s": 0.5},
              {"event": "job_done", "tenant": "a", "wall_s": 5.0},
              {"event": "job_failed", "tenant": "a"},
              {"event": "job_cancelled", "tenant": "a"},
              {"event": "job_done", "wall_s": 0.1}]
    got = slo_from_events(events, lambda t: SloObjective(*obj))
    want = jslo_from_events(events, lambda t: JObjective(*obj))
    assert got.snapshot() == want.snapshot()
    assert got.row("a")["good"] == 1 and got.row("a")["breaching"]
    logs = (_JobLog("j-1", tenant="acme"), JJobLog("j-1", tenant="acme"))
    for log in logs:
        log({"event": "job_done", "wall_s": 0.5})
        log({"event": "job_failed", "tenant": "other", "error": "x"})
    strip = [[{k: v for k, v in e.items() if k != "ts"}
              for e in log.events] for log in logs]
    assert strip[0] == strip[1]
    assert strip[0][0]["tenant"] == "acme" and strip[0][0]["job"] == "j-1"


# -- the service wiring ------------------------------------------------------


def _make_service(tmp_dir, tenants=None, slots=2):
    from dryad_tpu_torch.service import JobService, ServiceConfig
    return JobService(ServiceConfig(service_dir=tmp_dir, slots=slots,
                                    tenants=tenants or {}),
                      device="cpu")


def _serve(svc):
    from dryad_tpu_torch.service.http import Client, serve
    srv, port = serve(svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, Client(f"http://127.0.0.1:{port}")


def test_service_slo_endpoint_breach_and_dashboard():
    from dryad_tpu_torch.service import TenantQuota
    svc = _make_service(tempfile.mkdtemp(prefix="slo-svc-"), tenants={
        "acme": TenantQuota(slo_target=0.5, slo_latency_s=60.0,
                            slo_window=8)})
    srv, cl = _serve(svc)
    try:
        def bad_job(env):
            raise RuntimeError("boom")

        svc.wait(svc.submit_callable(lambda env: {"ok": True},
                                     tenant="acme"), timeout=60)
        assert cl.slo()["acme"]["attainment"] == 1.0
        for _ in range(2):
            svc.wait(svc.submit_callable(bad_job, tenant="acme"),
                     timeout=60)
        row = cl.slo()["acme"]
        assert row["jobs"] == 3 and row["good"] == 1
        assert row["burn_rate"] > 1.0 and row["breaching"] is True
        breaches = svc.log.of_type("slo_breach")
        assert len(breaches) == 1 and breaches[0]["tenant"] == "acme"
        mt = cl.metrics()
        assert 'dryad_slo_burn_rate{tenant="acme"}' in mt
        assert 'dryad_slo_attainment_ratio{tenant="acme"}' in mt
        html = svc.dashboard_html()
        assert "burn" in html and "attainment" in html
        svc.wait(svc.submit_callable(lambda env: 1, tenant="other"),
                 timeout=60)
        assert "other" not in cl.slo()
    finally:
        svc.close()
        srv.shutdown()


def test_events_streaming_two_concurrent_jobs_no_interleave():
    """Two jobs running at once on the fleet, each followed over SSE
    while running and by long poll after: every frame of a job's stream
    carries that job's id, from ``job_submitted`` to ``job_archived``."""
    svc = _make_service(tempfile.mkdtemp(prefix="sse-svc-"), slots=2)
    srv, cl = _serve(svc)
    try:
        both_running = threading.Barrier(2, timeout=30)
        release = threading.Event()

        def work(env):
            env.event({"event": "progress", "pct": 25.0, "done": 1,
                       "total": 4})
            both_running.wait()
            release.wait(30)
            env.event({"event": "progress", "pct": 100.0, "done": 4,
                       "total": 4})
            return {"ok": True}

        ja = svc.submit_callable(work, tenant="ta")
        jb = svc.submit_callable(work, tenant="tb")
        streams = {ja: [], jb: []}

        def follow(jid):
            streams[jid].extend(cl.stream_events(jid))

        threads = [threading.Thread(target=follow, args=(j,), daemon=True)
                   for j in (ja, jb)]
        for t in threads:
            t.start()
        time.sleep(0.6)
        release.set()
        assert svc.wait(ja, timeout=60)["state"] == "done"
        assert svc.wait(jb, timeout=60)["state"] == "done"
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "SSE stream never terminated"
        for jid in (ja, jb):
            kinds = [e["event"] for e in streams[jid]]
            assert "job_submitted" in kinds and "job_done" in kinds
            assert "job_archived" in kinds and kinds.count("progress") == 2
            assert all(e.get("job") == jid for e in streams[jid])
        first = cl.events(ja, after=0, timeout_s=1)
        assert first["state"] == "done"
        assert [e["event"] for e in first["events"]] == \
            [e["event"] for e in streams[ja]]
        again = cl.events(ja, after=first["next"], timeout_s=0)
        assert again["events"] == [] and again["next"] == first["next"]
        with pytest.raises(RuntimeError):
            cl.events("nope-1")
        with pytest.raises(RuntimeError, match="unknown job"):
            next(iter(cl.stream_events("nope-2")))
    finally:
        svc.close()
        srv.shutdown()


def test_progress_fraction_live_gauge_and_dashboard():
    svc = _make_service(tempfile.mkdtemp(prefix="prog-svc-"), slots=1)
    try:
        seen, release = threading.Event(), threading.Event()

        def work(env):
            env.event({"event": "progress", "pct": 50.0, "done": 1,
                       "total": 2, "stage": 0})
            seen.set()
            release.wait(30)
            return {"ok": True}

        jid = svc.submit_callable(work)
        assert seen.wait(30)
        row = svc.status(jid)
        assert row["state"] == "running" and row["progress_pct"] == 50.0
        assert f'dryad_job_progress_ratio{{job="{jid}"}} 0.5' \
            in svc.metrics_text()
        assert "50%" in svc.dashboard_html()
        release.set()
        assert svc.wait(jid, timeout=60)["state"] == "done"
        assert svc.status(jid)["progress_pct"] == 100.0
    finally:
        svc.close()


def test_level0_live_paths_are_noop(monkeypatch):
    """At DRYAD_LOGGING_LEVEL=0 a job's log records nothing, the
    progress gauge never engages, and the job still completes."""
    monkeypatch.setenv("DRYAD_LOGGING_LEVEL", "0")
    from dryad_tpu_torch.obs.metrics import REGISTRY
    svc = _make_service(tempfile.mkdtemp(prefix="lvl0-svc-"), slots=1)
    try:
        def work(env):
            env.event({"event": "progress", "pct": 50.0, "done": 1,
                       "total": 2})
            env.event({"event": "span", "name": "x"})
            return {"ok": True}

        before = {k for k in REGISTRY.snapshot()
                  if k.startswith("dryad_job_progress_ratio")}
        jid = svc.submit_callable(work)
        assert svc.wait(jid, timeout=60)["state"] == "done"
        assert svc.job(jid).log.events == []
        assert {k for k in REGISTRY.snapshot()
                if k.startswith("dryad_job_progress_ratio")} == before
    finally:
        svc.close()
