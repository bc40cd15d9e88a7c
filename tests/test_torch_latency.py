"""The port's tail-latency layer (``obs/latency.py``) against the JAX
package's: ``PhaseClock`` waterfalls on one scripted monotonic clock,
``QuantileSketch`` quantiles over seeded samples, ``LatencyTracker``
rows and snapshots, ``latency_from_events`` and the renderers, all equal
exactly (mirrors ``tests/test_latency.py``'s service-free tests)."""

import itertools
import json
import math

import numpy as np
import pytest

from dryad_tpu.obs import latency as jlat
from dryad_tpu.obs import metrics as jmetrics
from dryad_tpu_torch.obs import latency as tlat
from dryad_tpu_torch.obs import metrics as tmetrics
from dryad_tpu_torch.obs.__main__ import main as obs_main
from dryad_tpu_torch.utils.events import _LEVELS

# (phase, microseconds after the previous mark) scripts for PhaseClock
SCRIPTS = {
    "service": [("precheck", 120), ("bind", 800), ("queue", 2_000),
                ("dispatch", 15), ("run", 50_000), ("fetch", 300)],
    "repeat_dispatch": [("queue", 10), ("dispatch", 5), ("dispatch", 7),
                        ("run", 90)],
    "one": [("run", 1)],
    "empty": [],
}


def _clock(pkg, script, monkeypatch, once=False):
    """A PhaseClock of ``pkg`` driven by a scripted ``monotonic_ns``
    (the clock's only time source): t0, then one tick per mark."""
    ticks = itertools.accumulate([10 ** 9] + [us * 1000 + 37
                                              for _, us in script])
    monkeypatch.setattr(pkg.time, "monotonic_ns", lambda: next(ticks))
    ph = pkg.PhaseClock()
    for phase, _us in script:
        (ph.mark_once if once else ph.mark)(phase)
    return ph


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("once", [False, True])
def test_phase_clock_equals_jax(name, once, monkeypatch):
    t = _clock(tlat, SCRIPTS[name], monkeypatch, once)
    j = _clock(jlat, SCRIPTS[name], monkeypatch, once)
    assert t.segments() == j.segments()
    segs, wall = t.segments()
    assert sum(us for _, us in segs) == wall
    for kw in ({}, {"job": "j-1", "tenant": "acme", "trace": "t-9"},
               {"compile_s": 0.002, "ok": False},
               {"compile_s": 999.0, "app": "wc"}):
        wf = t.waterfall(**kw)
        assert wf == j.waterfall(**kw)
        assert sum(p["us"] for p in wf["phases"]) == wf["wall_us"]
        assert tlat.render_waterfall(wf) == jlat.render_waterfall(wf)


SAMPLES = {
    "uniform": np.random.RandomState(7).uniform(0.002, 30.0, 500),
    "lognormal": np.random.RandomState(3).lognormal(-3, 2, 2000),
    "edges": np.array([0.0, 1e-6, 0.001, 0.5, 0.5, 80.0, 120.0, 500.0]),
    "one": np.array([5.0]),
    "none": np.array([]),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_quantile_sketch_equals_jax(name):
    t, j = tlat.QuantileSketch(), jlat.QuantileSketch()
    for v in SAMPLES[name].tolist():
        t.observe(v)
        j.observe(v)
    qs = (0.0, 0.01, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    assert [t.quantile(q) for q in qs] == [j.quantile(q) for q in qs]
    assert (t.count, t.mean, t.vmin, t.vmax) == \
        (j.count, j.mean, j.vmin, j.vmax)
    assert tlat.SKETCH_BOUNDS == jlat.SKETCH_BOUNDS
    vals = sorted(SAMPLES[name].tolist())
    if name == "uniform":
        # within the covered range an estimate lies in the true order
        # statistic's geometric bucket: 0.8 x true <= est <= 1.25 x true
        for q in (0.1, 0.5, 0.9, 0.99):
            true = vals[max(0, math.ceil(q * len(vals)) - 1)]
            assert 0.8 * true - 1e-9 <= t.quantile(q) <= 1.25 * true + 1e-9


def _wf(job, tenant, segs, ok=True, trace=None):
    wf = {"event": "latency_waterfall", "ok": ok,
          "wall_us": sum(us for _, us in segs),
          "wall_s": round(sum(us for _, us in segs) / 1e6, 6),
          "phases": [{"phase": p, "us": us} for p, us in segs],
          "job": job, "tenant": tenant}
    if trace:
        wf["trace"] = trace
    return wf


def _waterfalls(n=60, seed=0):
    rng = np.random.RandomState(seed)
    phases = ("precheck", "bind", "queue", "dispatch", "compile", "run",
              "fetch", "custom")
    out = []
    for i in range(n):
        k = rng.randint(1, len(phases))
        segs = [(p, int(rng.randint(0, 200_000)))
                for p in rng.choice(phases, k, replace=False)]
        out.append(_wf(f"j-{i}", ("acme", "beta", "gamma")[i % 3], segs,
                       ok=bool(rng.rand() < 0.9),
                       trace=f"t-{i}" if i % 4 else None))
    return out


@pytest.mark.parametrize("window", [1, 4, 64])
def test_tracker_equals_jax(window):
    t, j = tlat.LatencyTracker(window=window), \
        jlat.LatencyTracker(window=window)
    for wf in _waterfalls() + [{}, {"event": "job_done"}]:
        t.record(wf)
        j.record(wf)
    assert t.snapshot() == j.snapshot()
    for tenant in ("acme", "beta", "gamma", "nope"):
        assert t.row(tenant) == j.row(tenant)
    assert tlat.render_text(t) == jlat.render_text(j)
    row = t.row("acme")
    assert row["count"] == 20
    assert sum(p["share"] for p in row["phases"]) == pytest.approx(
        1.0, abs=0.01)


def test_tracker_feeds_a_registry_like_jax():
    tr, jr = tmetrics.Registry(), jmetrics.Registry()
    t = tlat.LatencyTracker(registry=tr)
    j = jlat.LatencyTracker(registry=jr)
    for wf in _waterfalls(12, seed=1):
        t.record(wf)
        j.record(wf)
    assert tr.render() == jr.render()
    assert tr.snapshot() == jr.snapshot()


def test_latency_from_events_equals_jax():
    ev = _waterfalls(30, seed=2)
    ev[5:5] = [{"event": "job_done", "job": "j-4"}, {"event": "span"}]
    t, j = tlat.latency_from_events(ev), jlat.latency_from_events(ev)
    assert t.snapshot() == j.snapshot()
    # the two derivations: folding the records in order rebuilds a live
    # tracker's snapshot bit for bit
    live = tlat.LatencyTracker()
    for wf in ev:
        live.record(wf)
    assert live.snapshot() == t.snapshot()
    assert tmetrics.metrics_from_events(ev).render() == \
        jmetrics.metrics_from_events(ev).render()
    assert _LEVELS["latency_waterfall"] == 1 and _LEVELS["latency_phase"] == 2


def test_obs_cli_latency(tmp_path, capsys):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        for wf in (_wf("j-1", "acme", [("queue", 2000), ("run", 48000)],
                       trace="t-1"),
                   _wf("j-2", "beta", [("run", 5000)])):
            f.write(json.dumps(wf) + "\n")
        f.write(json.dumps({"event": "job_done", "job": "j-1"}) + "\n")
    assert obs_main(["latency", path]) == 0
    out = capsys.readouterr().out
    assert "acme" in out and "beta" in out and "dominant" in out
    assert obs_main(["latency", path, "--job", "j-1"]) == 0
    out = capsys.readouterr().out
    assert "j-1" in out and "beta" not in out
    assert obs_main(["latency", path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == \
        tlat.latency_from_events(
            [json.loads(x) for x in open(path)]).snapshot()
    assert obs_main(["latency", str(tmp_path / "nope.jsonl")]) == 2
    assert obs_main(["latency", path, "--job", "ghost"]) == 2
