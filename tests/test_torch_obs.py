"""The port's telemetry layer (``obs/trace.py``, ``metrics.py``,
``profile.py``, ``chrome.py``, ``critical_path.py``, ``history.py``, the
obs CLI, and the Run's spans, sampler and ``job_done``) against the JAX
package's on the same numpy inputs and on one recorded stream.  Times,
ids and paths are left out of every comparison.  The last test rehearses
chip_smoke.py's phase 15 on the CPU."""

import collections
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from dryad_tpu import Context as JContext
from dryad_tpu.apps import pagerank as jpr
from dryad_tpu.apps import wordcount as jwc
from dryad_tpu.obs import chrome as jchrome
from dryad_tpu.obs.critical_path import critical_path as j_critical_path
from dryad_tpu.obs.critical_path import render_text as j_render_text
from dryad_tpu.obs import history as jhistory
from dryad_tpu.obs import metrics as jmetrics
from dryad_tpu.obs.analyze import analyze_events as j_analyze_events
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu.utils.events import EventLog as JEventLog
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch import JobConfig
from dryad_tpu_torch.apps import pagerank as tpr
from dryad_tpu_torch.apps import wordcount as twc
from dryad_tpu_torch.obs import chrome, history, metrics
from dryad_tpu_torch.obs import profile, trace
from dryad_tpu_torch.obs.__main__ import OBS_COMMANDS
from dryad_tpu_torch.obs.__main__ import main as obs_main
from dryad_tpu_torch.obs.analyze import analyze_events
from dryad_tpu_torch.obs.critical_path import critical_path, render_text
from dryad_tpu_torch.ops import _build
from dryad_tpu_torch.utils.events import EventLog
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = [b"the quick brown fox", b"jumps over the lazy dog",
         b"the dog barks", b"a b c d e f"] * 150


@pytest.fixture(autouse=True)
def no_trace_sink():
    """Each test starts and ends with no process span sink (a Context
    installs its log as the sink)."""
    trace.install(None)
    yield
    trace.install(None)


def _wc(pkg_ctx, wc):
    return wc.wordcount_query(pkg_ctx.from_columns({"line": LINES})) \
        .collect()


def _pr(pkg_ctx, pr):
    return pr.pagerank(pkg_ctx, pr.gen_graph(64, 256, seed=0), 64,
                       n_iters=3)


APPS = {"wordcount": ((_wc, jwc), (_wc, twc)),
        "pagerank": ((_pr, jpr), (_pr, tpr))}


def _structure(events):
    """(name, kind, parent's name) of every span, in emission order."""
    spans = [e for e in events if e["event"] == "span"]
    by = {e["span"]: e["name"] for e in spans}
    return [(e["name"], e["kind"], by.get(e.get("parent")))
            for e in spans]


def _recorded(devices8, app):
    """One run of ``app`` in each package with an EventLog at level 2:
    (JAX events, port events)."""
    (jf, jm), (tf, tm) = APPS[app]
    jl = JEventLog(level=2)
    jf(JContext(event_log=jl), jm)
    jl.close()
    tl = EventLog(level=2)
    tf(TContext(device="cpu", nparts=P, event_log=tl), tm)
    tl.close()
    return jl.events, tl.events


# -- the Run's spans, job_done and sampler ------------------------------------

@pytest.mark.parametrize("app", sorted(APPS))
def test_span_structure_equals_jax(devices8, app):
    jev, tev = _recorded(devices8, app)
    assert _structure(tev) == _structure(jev)
    jobs = [e for e in tev if e["event"] == "span" and e["kind"] == "job"]
    assert [e["name"] for e in jobs] == ["run"] * len(
        [e for e in tev if e["event"] == "job_done"])
    ids = {e["span"]: e for e in tev if e["event"] == "span"}
    for e in ids.values():
        if e["kind"] == "stage":
            assert ids[e["parent"]]["kind"] == "job"
            assert e["trace"] == ids[e["parent"]]["trace"]
    # the attributes too: the stage, its label, whether it was deferred
    # (a settle replay computes its stages synchronously)
    assert [e.get("attrs") for e in tev if e["event"] == "span"] == \
        [e.get("attrs") for e in jev if e["event"] == "span"]


@pytest.mark.parametrize("app", sorted(APPS))
def test_job_done_keys_equal_jax(devices8, app):
    jev, tev = _recorded(devices8, app)
    jdone = [e for e in jev if e["event"] == "job_done"]
    tdone = [e for e in tev if e["event"] == "job_done"]
    assert [sorted(e) for e in tdone] == [sorted(e) for e in jdone]
    jobs = [e["trace"] for e in tev
            if e["event"] == "span" and e["kind"] == "job"]
    assert [e["trace"] for e in tdone] == jobs
    assert all(isinstance(e["metrics"], dict) and
               e["metrics"]["dryad_stage_runs_total"] >= 1 for e in tdone)
    # below level 2 there is no job span, so no trace id
    log = EventLog(level=1)
    _wc(TContext(device="cpu", nparts=P, event_log=log), twc)
    (done,) = log.of_type("job_done")
    assert "trace" not in done and "metrics" in done
    assert not log.of_type("span")


def _sampler_threads():
    return [t for t in threading.enumerate()
            if t.name == "dryad-resource-sampler"]


def test_sampler_starts_and_stops(devices8):
    before = threading.active_count()
    log = EventLog(level=2)
    ctx = TContext(device="cpu", nparts=P, event_log=log,
                   config=JobConfig(resource_sample_s=0.005))
    _pr(ctx, tpr)
    assert threading.active_count() == before and not _sampler_threads()
    samples = log.of_type("resource_sample")
    # one at the start and one at the stop of each run, at least
    assert len(samples) >= 2 * len(log.of_type("job_done"))
    assert all(s["role"] == "driver" and s["rss_bytes"] > 0
               and "gc_counts" in s for s in samples)
    # the port reports no device figure from the host
    assert not any("device_bytes" in s for s in samples)
    # no consumer at level 2, or a zero period: no sampler, no samples
    for lvl, period in ((1, 0.005), (2, 0.0)):
        quiet = EventLog(level=lvl)
        _wc(TContext(device="cpu", nparts=P, event_log=quiet,
                     config=JobConfig(resource_sample_s=period)), twc)
        assert not quiet.of_type("resource_sample")
    assert profile.start(None, 0.01) is None
    assert profile.start(EventLog(level=1), 0.01) is None
    with pytest.raises(ValueError, match="resource_sample_s"):
        JobConfig(resource_sample_s=-0.1)


def test_sampler_stop_joins_its_thread():
    got = []
    s = profile.start(got.append, 0.001, role="driver")
    assert len(_sampler_threads()) == 1
    time.sleep(0.02)
    s.stop()
    assert not _sampler_threads() and len(got) >= 3
    assert all(e["event"] == "resource_sample" for e in got)


def test_device_bytes_only_from_initialized_cuda(monkeypatch):
    """``device_bytes`` is ``torch.cuda.memory_allocated`` of the run's
    CUDA device, read only once CUDA is initialized (a sampler never
    initializes it); a CPU device has none."""
    asked = []
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: asked.append(d) or 4096)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert profile._device_bytes(torch.device("cuda")) is None
    assert profile.sample_now(device="cuda").get("device_bytes") is None
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert profile._device_bytes(torch.device("cpu")) is None
    assert profile._device_bytes(None) is None
    assert asked == []
    assert profile._device_bytes(torch.device("cuda", 0)) == 4096
    assert profile.sample_now(device="cuda")["device_bytes"] == 4096


def test_diagnose_events_equals_jax():
    rows = [[5, 5, 5, 5, 5, 5, 5, 80], [10] * 8, [0, 0, 1, 0, 0, 0, 0, 0],
            [3, 3, 3, 3, 3, 3, 3, 30]]
    events = [{"event": "stage_done", "stage": i, "label": f"s{i}",
               "rows": r} for i, r in enumerate(rows)]
    events += [{"event": "task_done", "worker": w, "wall_s": s}
               for w, s in ((0, 1.0), (0, 1.2), (1, 1.1), (1, 0.9),
                            (2, 5.0), (2, 6.0))]
    from dryad_tpu.obs.profile import diagnose_events as jdiag
    assert profile.diagnose_events(events) == jdiag(events)
    assert [e["stage"] for e in profile.diagnose_events(events)
            if e["event"] == "diagnosis_skew"] == [0, 3]


# -- tracing core -------------------------------------------------------------

def test_span_gating_and_wire_context(monkeypatch):
    monkeypatch.setenv("DRYAD_LOGGING_LEVEL", "0")
    sink = []
    trace.install(sink.append)
    assert not trace.tracing_enabled()
    with trace.span("x", "io") as sp:
        assert sp is trace.NULL
    assert trace.start("y") is None and sink == []
    monkeypatch.setenv("DRYAD_LOGGING_LEVEL", "2")
    log = EventLog(level=2)
    trace.install(log)
    with trace.span("job 1", "job") as j:
        with trace.span("stage 0:wc", "stage", stage=0):
            pass
        worker = []
        with trace.tracing(worker.append, trace.ctx_of(j)):
            with trace.span("task 0", "task") as t:
                t.set(rows=3)
    spans = log.of_type("span")
    assert [s["name"] for s in spans] == ["stage 0:wc", "job 1"]
    assert spans[0]["parent"] == j.span_id
    assert worker[0]["parent"] == j.span_id and \
        worker[0]["trace"] == j.trace_id and \
        worker[0]["attrs"] == {"rows": 3}
    # an explicit level wins over the env, both ways
    rec = []
    assert trace.start("z", sink=trace.leveled(rec.append, 0)) is None
    monkeypatch.setenv("DRYAD_LOGGING_LEVEL", "0")
    trace.finish(trace.start("z", sink=trace.leveled(rec.append, 2)))
    assert len(rec) == 1
    with pytest.raises(ValueError):
        with trace.span("boom"):
            raise ValueError("x")
    assert log.of_type("span")[-1]["attrs"]["error"] == "ValueError"


def test_concurrent_emitters_stress(tmp_path, monkeypatch):
    """More emitting threads than cores with a tiny switch interval: a
    sampler, span writers and compile-clock adders on one EventLog with a
    JSONL file.  Every event lands once as one whole line, span ids never
    collide, and the compile clock loses no update."""
    import sys
    log = EventLog(str(tmp_path / "ev.jsonl"), level=2)
    n_threads, n_each = 2 * (os.cpu_count() or 4), 200
    monkeypatch.setattr(_build, "_COMPILE_S", [0.0])
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sampler = profile.start(log, 0.001, role="driver")

        def work():
            for _ in range(n_each):
                trace.finish(trace.start("s", "stage", sink=log))
                _build._add_compile_s(0.5)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        sampler.stop()
    finally:
        sys.setswitchinterval(prev)
    log.close()
    with open(tmp_path / "ev.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert lines == log.events
    spans = [e["span"] for e in lines if e["event"] == "span"]
    assert len(spans) == len(set(spans)) == n_threads * n_each
    assert _build.compile_seconds() == n_threads * n_each * 0.5


def test_eventlog_close_detaches_trace_sink():
    log = EventLog(level=2)
    trace.install(log)
    assert trace.tracing_enabled()
    log.close()
    assert not trace.tracing_enabled()
    with trace.span("late") as sp:
        assert sp is trace.NULL
    # a later Context owns the sink; a log-less one detaches it
    log2 = EventLog(level=2)
    TContext(device="cpu", nparts=P, event_log=log2)
    assert trace.tracing_enabled()
    TContext(device="cpu", nparts=P)
    assert not trace.tracing_enabled()
    TContext(device="cpu", nparts=P, event_log=log2, install_trace=False)
    assert not trace.tracing_enabled()


# -- metrics ------------------------------------------------------------------

def test_families_equal_jax():
    assert metrics.FAMILIES == jmetrics.FAMILIES
    assert metrics.PER_JOB_FAMILIES == jmetrics.PER_JOB_FAMILIES


def test_compile_s_is_the_kernel_build(devices8, monkeypatch):
    """``stage_done.compile_s`` is the compiler wall the attempt spent
    (``_build.compile_seconds``): the first stage's share, 0.0 after."""
    clock = iter([0.0, 1.25] + [1.25] * 1000)
    monkeypatch.setattr(_build, "compile_seconds", lambda: next(clock))
    log = EventLog(level=1)
    ctx = TContext(device="cpu", nparts=P, event_log=log)
    ctx.from_columns({"k": np.arange(64, dtype=np.int32) % 5}) \
        .group_by(["k"], {"n": ("count", None)}).order_by([("k", False)]) \
        .collect()
    comp = [e["compile_s"] for e in log.of_type("stage_done")]
    assert comp[0] == 1.25 and all(c == 0.0 for c in comp[1:])
    assert "cache_hit" not in log.of_type("stage_done")[0]
    snap = metrics.metrics_from_events(log.events).snapshot()
    assert snap["dryad_compile_seconds_total"] == 1.25
    assert "dryad_compile_cache_hits_total" not in snap


def _stream(devices8):
    """One recorded port stream: PageRank at level 2 under lint "warn"
    (cost reports), then a wordcount."""
    log = EventLog(level=2)
    ctx = TContext(device="cpu", nparts=P, event_log=log,
                   config=JobConfig(lint="warn", resource_sample_s=0.01))
    _pr(ctx, tpr)
    _wc(ctx, twc)
    log.close()
    return log.events


def test_recorded_stream_derivations_equal_jax(devices8):
    """metrics_from_events(...).snapshot(), chrome_trace, critical_path,
    analyze_events, render texts: equal JSON in both packages over one
    recorded stream."""
    ev = _stream(devices8)
    kinds = collections.Counter(e["event"] for e in ev)
    assert kinds["span"] and kinds["cost_report"] and \
        kinds["resource_sample"] and kinds["job_done"]
    assert metrics.metrics_from_events(ev).snapshot() == \
        jmetrics.metrics_from_events(ev).snapshot()
    assert metrics.metrics_from_events(ev, by_job=True).render() == \
        jmetrics.metrics_from_events(ev, by_job=True).render()
    assert json.dumps(chrome.chrome_trace(ev)) == \
        json.dumps(jchrome.chrome_trace(ev))
    cp = critical_path(ev)
    assert json.dumps(cp) == json.dumps(j_critical_path(ev))
    assert render_text(cp) == j_render_text(cp)
    rep = analyze_events(ev)
    assert rep.to_payload() == j_analyze_events(ev).to_payload()
    assert rep.render() == j_analyze_events(ev).render()
    assert rep.misses == 0 and rep.stage_runs == kinds["stage_done"]


def _strip(summary):
    return {k: v for k, v in summary.items() if k not in ("ts", "dir")}


def test_history_archive_layout_and_summary_equal_jax(devices8, tmp_path):
    ev = _stream(devices8)
    tdir = history.archive_job(str(tmp_path / "t"), ev, app="pr")
    jdir = jhistory.archive_job(str(tmp_path / "j"), ev, app="pr")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "events.jsonl", "metrics.json", "plan.json", "summary.json"]
    for name in ("metrics.json", "plan.json"):
        with open(os.path.join(tdir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read()
    with open(os.path.join(tdir, "summary.json")) as a, \
            open(os.path.join(jdir, "summary.json")) as b:
        ts, js = json.load(a), json.load(b)
    assert _strip(ts) == _strip(js) and ts["app"] == "pr"
    with open(os.path.join(tdir, "events.jsonl")) as a, \
            open(os.path.join(jdir, "events.jsonl")) as b:
        assert [json.loads(x)["event"] for x in a] == \
            [json.loads(x)["event"] for x in b]
    # a second run of the app: the index shows its delta
    history.archive_job(str(tmp_path / "t"), ev, app="pr")
    jhistory.archive_job(str(tmp_path / "j"), ev, app="pr")
    ti = history.history_index(str(tmp_path / "t"))
    ji = jhistory.history_index(str(tmp_path / "j"))
    assert [_strip(e) for e in ti] == [_strip(e) for e in ji]
    assert ti[1]["d_wall_pct"] == 0.0
    assert "pr" in history.render_history_text(ti)


def test_context_history_dir_archives_on_close(devices8, tmp_path):
    """JobConfig.history_dir reaches the Context's EventLog (an explicit
    EventLog(history_dir=) wins); close() archives the job and logs
    ``job_archived``, in both packages with one layout."""
    layouts = []
    for pkg_ctx, log_cls, cfg, wc, sub in (
            (lambda **kw: TContext(device="cpu", nparts=P, **kw), EventLog,
             JobConfig, twc, "t"),
            (JContext, JEventLog, JJobConfig, jwc, "j")):
        hist = str(tmp_path / sub)
        log = log_cls(level=1, app="wc")
        _wc(pkg_ctx(event_log=log, config=cfg(history_dir=hist)), wc)
        assert log.history_dir == hist
        log.close()
        (arch,) = log.of_type("job_archived")
        layouts.append(sorted(os.listdir(arch["path"])))
        assert os.path.dirname(arch["path"]) == hist
    assert layouts[0] == layouts[1]
    own = EventLog(history_dir=str(tmp_path / "own"))
    TContext(device="cpu", nparts=P, event_log=own,
             config=JobConfig(history_dir=str(tmp_path / "cfg")))
    assert own.history_dir == str(tmp_path / "own")


def test_profile_dir_writes_a_chrome_trace(devices8, tmp_path):
    """JobConfig.profile_dir on the CPU: each executor run writes one
    Chrome trace (host activity; CUDA activity is traced on the card)."""
    cfg = JobConfig(profile_dir=str(tmp_path / "prof"))
    ctx = TContext(device="cpu", nparts=P, config=cfg)
    out = _wc(ctx, twc)
    assert sorted(out["line"])[:2] == [b"a", b"b"]
    (path,) = ctx.executor.profile_paths
    assert os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as f:
        doc = json.load(f)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_launches_without_record_past_the_pad():
    """The profile_dir check: a kernel launch (runtime or driver call)
    past the first ``skip`` in correlation order whose correlation id
    has no device record counts as dropped; other host calls and ops do
    not."""
    from dryad_tpu_torch.exec.executor import _launches_without_record

    class Ev:
        def __init__(self, dev, name, corr):
            self._dev, self._name, self._corr = dev, name, corr

        def device_type(self):
            return self._dev

        def name(self):
            return self._name

        def correlation_id(self):
            return self._corr

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    full = [Ev(cpu, "aten::add", 1), Ev(cpu, "cudaLaunchKernel", 3),
            Ev(cuda, "void hist_small<8>(...)", 3),
            Ev(cpu, "cuLaunchKernelEx", 9), Ev(cuda, "slot_compact_v2", 9),
            Ev(cpu, "cudaMemcpyAsync", 15), Ev(cpu, "cudaLaunchHostFunc", 21)]
    assert _launches_without_record(full) == (2, 0)
    assert _launches_without_record(full[:4]) == (1, 1)
    cpu_only = [e for e in full if e._dev == cpu]
    assert _launches_without_record(cpu_only) == (0, 2)
    # the first launches in correlation order (the pad) are not held
    assert _launches_without_record(cpu_only[::-1], skip=1) == (0, 1)
    assert _launches_without_record(full[1:2] + full[3:], skip=1) == (1, 0)
    assert _launches_without_record([Ev(cpu, "aten::add", 1)]) == (0, 0)


# -- the obs CLI --------------------------------------------------------------

def test_obs_commands():
    assert OBS_COMMANDS == ("trace", "critical-path", "metrics",
                            "analyze", "latency", "replay", "history")
    from dryad_tpu.obs.__main__ import OBS_COMMANDS as J
    assert OBS_COMMANDS == J


def _clean_bundle(d) -> str:
    """A persisted forensics bundle of a healthy wordcount task with no
    recorded error: its replay runs clean."""
    from dryad_tpu_torch.obs import flight
    from dryad_tpu_torch.plan.planner import plan_query
    from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster
    ctx = TContext(cluster=types.SimpleNamespace(devices_per_process=2))
    q = twc.wordcount_query(ctx.from_columns({"line": ["a b a"]}),
                            tokens_per_partition=16)
    plan, specs = serialize_for_cluster(plan_query(q.node, 2))
    b = flight.capture_bundle({"plan": plan, "sources": specs},
                              ValueError("unused"), device="cpu",
                              nparts=2)
    b["error"] = None
    return flight.persist_bundle(b, str(d))


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A recorded JSONL (one wordcount at level 2 under lint "warn", with
    a latency waterfall appended) and a history directory of it."""
    d = tmp_path_factory.mktemp("obs")
    p = str(d / "ev.jsonl")
    hist = str(d / "hist")
    with EventLog(p, level=2, history_dir=hist, app="wc") as log:
        _wc(TContext(device="cpu", nparts=P, event_log=log,
                     config=JobConfig(lint="warn")), twc)
        log({"event": "latency_waterfall", "job": "j1", "tenant": "t",
             "wall_us": 1000, "phases": [{"phase": "queue", "us": 400},
                                         {"phase": "run", "us": 600}]})
    trace.install(None)
    return p, hist


@pytest.mark.parametrize("cmd", OBS_COMMANDS)
def test_obs_cli_subcommand(recorded, cmd, tmp_path, capsys):
    p, hist = recorded
    args = {"trace": [p, "-o", str(tmp_path / "t.json")],
            "critical-path": [p, "--json"], "metrics": [p],
            "analyze": [p, "--json"], "latency": [p, "--json"],
            "replay": [_clean_bundle(tmp_path) if cmd == "replay" else "",
                       "--device", "cpu"],
            "history": [hist, "--html", str(tmp_path / "i.html")]}[cmd]
    assert obs_main([cmd, *args]) == 0
    out = capsys.readouterr().out
    if cmd == "trace":
        with open(tmp_path / "t.json") as f:
            assert json.load(f)["traceEvents"]
    elif cmd == "critical-path":
        assert json.loads(out)["total_s"] > 0
    elif cmd == "metrics":
        assert "dryad_stage_runs_total" in out
    elif cmd == "analyze":
        assert json.loads(out)["predicted"] is True
    elif cmd == "latency":
        assert json.loads(out)["t"]["count"] == 1
    elif cmd == "replay":
        assert "task completed without error" in out
    else:
        assert "wc" in out and (tmp_path / "i.html").exists()
    # malformed input exits 2
    assert obs_main([cmd, str(tmp_path / "missing")]) == 2


def test_obs_cli_in_a_process(recorded):
    p, hist = recorded
    out = subprocess.run([sys.executable, "-m", "dryad_tpu_torch.obs",
                          "analyze", p], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "settled" in out.stdout
    out = subprocess.run([sys.executable, "-m", "dryad_tpu_torch.obs",
                          "replay", p], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and "cannot load bundle" in out.stderr


# -- chip_smoke.py's phase 15, rehearsed on the CPU ---------------------------

def test_chip_smoke_phase15_rehearsal(monkeypatch, tmp_path):
    """chip_smoke.py's phase 15 on the CPU (20,000 lineitems, 1,000
    nodes; the card's synchronize stubbed, no profile cell) with every
    plain kernel version bumping its launch counter: EXPLAIN ANALYZE's
    report against the run's stage_done events, PageRank with telemetry
    off and on (ranks bit-equal, host reads equal, spans, job_done,
    samples without device_bytes, the history archives, the obs CLI in
    subprocesses), every launch counted and every captured call held."""
    import chip_smoke
    from dryad_tpu_torch import sql
    from dryad_tpu_torch.ops import hopper_kernels as hk
    for name, plain in (("hist_buckets", "hist_buckets_batched_plain"),
                        ("prefix_sum", "prefix_sum_plain"),
                        ("prefix_sum2", "prefix_sum2_plain"),
                        ("slot_expand", "slot_expand_batched_plain"),
                        ("slot_compact", "slot_compact_batched_plain")):
        real = getattr(hk, plain)

        def bump(*a, _real=real, _name=name):
            if a[0].device.type != "meta":
                hk.launches[_name] += 1
            return _real(*a)
        monkeypatch.setattr(hk, plain, bump)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    port = types.SimpleNamespace(
        Context=lambda device="cuda", **kw: TContext(device="cpu", **kw),
        JobConfig=JobConfig)
    runs = {}

    def held(label, launches, captured):
        runs[label] = (launches, chip_smoke.hold_run(hk, label, captured))

    _li, _orders, cat = chip_smoke.sql_catalog(sql, 20_000)
    edges = tpr.gen_graph(1000, 10_000, seed=0)
    out = dict(chip_smoke.phase15_runs(port, hk, cat, tpr, edges, 1000,
                                       str(tmp_path), held, device="cpu",
                                       profile=False))
    assert sorted(out) == ["obs_pagerank100k", "obs_sqlq3_6m"]
    q3 = out["obs_sqlq3_6m"]
    assert q3["cost_model_miss"] == 0 and q3["checked_stages"]
    assert [(s["label"], s["runs"]) for s in q3["stages"]][0] == ("join", 2)
    pr = out["obs_pagerank100k"]
    assert pr["ranks_bit_equal"] and \
        len(pr["history_jobs"]) == chip_smoke.OBS_REPS
    assert sorted(pr["cli_s"]) == sorted(chip_smoke.OBS_CLI)
    for t in pr["telemetry"]:
        assert t["job_spans"] == t["job_done"] == 13
        assert t["samples"] >= 26 and t["device_bytes_max"] is None
    launched = {k: sum(r[0][k] for r in runs.values())
                for k in chip_smoke.TPU_KERNEL}
    assert all(launched.values()), launched
    # the off and on runs, and the ANALYZE run
    assert len(runs) == 2 * chip_smoke.OBS_REPS + 1
    assert all(e == 0.0 for _, errs in runs.values() for e in errs.values())
