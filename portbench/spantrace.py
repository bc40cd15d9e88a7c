"""The span window of a traced run: ``TRACE_JOBS`` more jobs, after the
profile window of ``bench.trace_jobs``, with the program's own spans
recorded (``dryad_tpu_torch/obs/trace.py``) and the device trace joined
to them.

The port stamps its spans on ``time.time_ns()``, the clock torch.profiler
stamps its host-side runtime events in.  So every device record (kernel,
copy or memset) goes to the span that launched it: the record's
correlation id names its runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...), and that call's host
start falls in the innermost program span open at that instant.  A
record whose correlation id names no runtime call is counted under
``(none)``, with the records launched outside every span.  Each
synchronising runtime call (``SYNCS``) is counted by the innermost span
it falls in.

A span's name path runs from below the job's ``query`` and ``run``
spans down to it (``stage 4:join/op.join/hash``).  A share is the union
of the intervals of the records whose path holds a span of that name,
clipped to the window, over the window's busy seconds: a ``hash`` inside
an ``exchange.hash`` counts once in each share.

The per-layer readers are given the run's record alone, so the window
is taken by the first of them that asks (``of``), with the run's client
found in the harness's ``run`` frame, and kept on the record.  It adds
three keys to the result line's ``breakdown`` (``device_spans``,
``idle_spans``, ``syncs_by_span``) and prints its own figures to
standard error: the clock check (a span opened around one pad launch),
the share of busy time attributed below the stages, the records whose
span belongs to another job, and the window's mean job wall and idle
share beside the profile window's, the cost of tracing when on.  A
program without the spans (no ``trace.scope``) gets no window, and the
readers return None.
"""

from __future__ import annotations

import json
import sys
import time

from portbench import devtrace

# synchronising runtime calls: the host waits for the device in each
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
# the spans below a stage the device's time should fall in
BELOW_STAGE = ("op.", "exchange.", "settle", "collect", "cache")
NONE = "(none)"
TOP = 10


class Collector(list):
    """An in-memory span sink at level 2: the span events, in the order
    they finished."""

    level = 2

    def __call__(self, e: dict) -> None:
        if e.get("event") == "span" and "start_ns" in e:
            self.append(e)


def of(rec: dict):
    """The span window of this run (``take``), taken at the
    first call and kept on ``rec``; None where there is none to take."""
    if "spans" not in rec:
        rec["spans"] = None
        found = _harness_run()
        if found is not None and rec.get("trace") is not None:
            rec["spans"] = take(rec, *found)
    return rec["spans"]


def _harness_run():
    """(the client, the device, the bench module) of the harness's
    ``run`` on this thread's stack, or None."""
    from portbench import bench
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is bench.run.__code__:
            loc = f.f_locals
            return loc["client"], loc["device"], bench
        f = f.f_back
    return None


def take(rec: dict, client, device, bench) -> dict | None:
    """``bench.TRACE_JOBS`` jobs of ``client`` with a span collector
    installed (under the profiler on a card), their spans joined to the
    device trace.  The jobs join the traced jobs the check judges."""
    from dryad_tpu_torch.obs import trace
    if not hasattr(trace, "scope") or client.ex is None:
        return None
    n = bench.TRACE_JOBS
    sink = Collector()

    def run_jobs():
        del sink[:]
        marks, jobs = [], []
        with trace.tracing(sink):
            for _ in range(n):
                a = time.time_ns()
                jobs.append(client.one())
                marks.append((a, time.time_ns()))
        return jobs, marks

    if device.type == "cuda":
        (jobs, marks), prof = profile(run_jobs, device)
    else:
        (jobs, marks), prof = run_jobs(), {"records": [], "launches": {},
                                           "syncs": [], "clock": None}
    rec["trace"]["jobs"].extend(jobs)
    out = joined(list(sink), prof, marks[0][0], marks[-1][1])
    out["jobs"] = n
    out["wall_ms"] = [(b - a) / 1e6 for a, b in marks]
    out["metrics"] = metrics(out)
    _report(rec, out)
    _extend_breakdown(bench, rec["trace"], out)
    return out


def profile(run_jobs, device):
    """``run_jobs()`` under the profiler: (its result, the window's
    device records with their correlation ids, runtime calls and the
    clock check).  A window in which a kernel launch of the jobs has no
    device record is taken again, jobs and all, at most
    ``devtrace.WINDOWS`` times, as ``devtrace.profile_jobs`` does."""
    for _ in range(devtrace.WINDOWS):
        out, prof, launched, lost = window(run_jobs, device)
        if launched and not lost:
            return out, prof
    raise RuntimeError(f"every one of {devtrace.WINDOWS} span windows "
                       f"lacks device records: {lost} of {launched} "
                       f"kernel launches of the jobs have none")


def window(run_jobs, device):
    """One window around ``run_jobs()``, padded as ``devtrace.window``
    pads, with one more pad launch inside a pair of ``time.time_ns()``
    reads: ``(result, prof, launched, lost)``.  ``prof`` has
    ``records`` ``(name, start_ns, end_ns, correlation)``, ``launches``
    (correlation -> host start of the runtime call), ``syncs``
    ``(name, start_ns)`` and ``clock``: the bounds on the profiler's
    clock less ``time.time_ns()`` that the pad launch gives, in ns."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_
    pad = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with prof_(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(devtrace.PAD_HEAD):
            pad.add_(1)
        torch.cuda.synchronize()
        c0 = time.time_ns()
        pad.add_(1)
        c1 = time.time_ns()
        torch.cuda.synchronize()
        out = run_jobs()
        torch.cuda.synchronize()
        for _ in range(devtrace.PAD_TAIL):
            pad.add_(1)
        torch.cuda.synchronize()
    kernels, recorded, dev, calls, syncs = [], set(), [], {}, []
    for e in p.profiler.kineto_results.events():
        c = e.correlation_id()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            recorded.add(c)
            dev.append(e)
            continue
        name = e.name()
        if c:
            calls[c] = (name, e.start_ns(), e.end_ns())
        if name in SYNCS:
            syncs.append((name, e.start_ns()))
        if "Launch" in name and "Kernel" in name:
            kernels.append(c)
    kernels.sort()
    head = kernels[:devtrace.PAD_HEAD + 1]
    own = kernels[devtrace.PAD_HEAD + 1:len(kernels) - devtrace.PAD_TAIL]
    pads = set(head) | set(kernels[len(kernels) - devtrace.PAD_TAIL:])
    lost = sum(c not in recorded for c in own)
    records = [(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
               for e in dev if e.correlation_id() not in pads]
    clock = None
    if head and head[-1] in calls:
        _n, s, e = calls[head[-1]]
        # the launch lies within [c0, c1] on the program's clock: the
        # profiler's clock less it lies within [e - c1, s - c0]
        clock = (e - c1, s - c0)
    prof = {"records": records, "clock": clock,
            "launches": {c: s for c, (_n, s, _e) in calls.items()},
            "syncs": syncs}
    return out, prof, len(own), lost


def innermost(spans: list, times: list) -> list:
    """For each instant of ``times``, the index into ``spans`` of the
    innermost span open at it (start <= t < end), or None.  The spans
    nest, as the spans of one thread do."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i]["start_ns"], -spans[i]["end_ns"]))
    out = [None] * len(times)
    stack, j = [], 0
    for ti in sorted(range(len(times)), key=times.__getitem__):
        t = times[ti]
        while j < len(order) and spans[order[j]]["start_ns"] <= t:
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]]["end_ns"] <= t:
            stack.pop()
        # an ended span below an open one (spans that do not nest) is
        # never the top
        out[ti] = stack[-1] if stack else None
    return out


def paths(spans: list) -> list:
    """Each span's name path below the job's ``query`` and ``run``
    spans (its own name where nothing lies below them)."""
    by_id = {s["span"]: s for s in spans}
    out = []
    for s in spans:
        names, at, seen = [], s, set()
        while at is not None and at["span"] not in seen:
            seen.add(at["span"])
            if at.get("kind") not in ("query", "job"):
                names.append(at["name"])
            at = by_id.get(at.get("parent"))
        out.append("/".join(reversed(names)) or s["name"])
    return out


def joined(spans: list, prof: dict, lo: int, hi: int) -> dict:
    """The window's device records and runtime syncs attributed to
    ``spans`` (the collector's events), over [lo, hi] ns."""
    names = paths(spans)
    recs = prof["records"]
    at = [prof["launches"].get(c) for _n, _s, _e, c in recs]
    owner = innermost(spans, [t if t is not None else -1 for t in at])
    rec_path = [names[i] if i is not None else NONE for i in owner]
    sync_owner = innermost(spans, [t for _n, t in prof["syncs"]])
    runs = [i for i, s in enumerate(spans) if s.get("kind") == "job"]
    # the run span each launch fell in: its job
    run_of = innermost([spans[i] for i in runs],
                       [t if t is not None else -1 for t in at])
    other_job = sum(
        1 for k, r in enumerate(run_of)
        if r is not None and owner[k] is not None
        and spans[owner[k]]["trace"] != spans[runs[r]]["trace"])
    iv = [(s, e) for _n, s, e, _c in recs]
    busy = devtrace.union_seconds(iv, lo, hi) / 1e9
    by_path: dict = {}
    for (_n, s, e, _c), p in zip(recs, rec_path):
        by_path[p] = by_path.get(p, 0.0) + (e - s) / 1e9
    return {"spans": spans, "paths": names, "records": recs,
            "rec_path": rec_path, "lo_ns": lo, "hi_ns": hi,
            "busy_s": busy, "window_s": (hi - lo) / 1e9,
            "by_path": by_path, "clock": prof["clock"],
            "no_launch": sum(t is None for t in at),
            "other_job": other_job,
            "syncs": [(n, names[i] if i is not None else NONE,
                       any(spans[j]["start_ns"] <= t < spans[j]["end_ns"]
                           for j in runs))
                      for (n, t), i in zip(prof["syncs"], sync_owner)]}


def share(st: dict, test) -> float | None:
    """% of the window's busy seconds under a span whose name passes
    ``test`` (anywhere on the record's path): the union of those
    records' intervals.  None without device records."""
    if not st["records"] or not st["busy_s"]:
        return None
    iv = [(s, e) for (_n, s, e, _c), p in zip(st["records"], st["rec_path"])
          if p != NONE and any(test(seg) for seg in p.split("/"))]
    return 100.0 * devtrace.union_seconds(
        iv, st["lo_ns"], st["hi_ns"]) / 1e9 / st["busy_s"]


def _span_total(st: dict, name: str, key=None):
    """The sum over the spans named ``name`` of their ``key`` attribute
    (their ns where ``key`` is None), or None where there is none."""
    got = [(s["end_ns"] - s["start_ns"]) if key is None
           else (s.get("attrs") or {}).get(key, 0)
           for s in st["spans"] if name(s["name"])]
    return sum(got) if got else None


def metrics(st: dict) -> dict:
    """The new per-layer metrics of the window (None where unread)."""
    n = st["jobs"]
    dev = bool(st["records"])
    gib = _span_total(st, lambda s: s.startswith("exchange."), "bytes")
    plan = _span_total(st, lambda s: s == "plan")
    coll = _span_total(st, lambda s: s == "collect")
    return {
        "exchange_device_pct": share(st, lambda s: s.startswith(
            "exchange.")),
        "hash_device_pct": share(st, lambda s: s == "hash"),
        "sort_device_pct": share(st, lambda s: s == "sort"),
        "exchange_gib_per_job": gib / n / 2**30 if gib is not None
        else None,
        "host_syncs_per_job": (sum(1 for _n, _p, in_run in st["syncs"]
                                   if in_run) / n if dev else None),
        "plan_span_ms_per_job": plan / n / 1e6 if plan is not None
        else None,
        "collect_span_ms_per_job": coll / n / 1e6 if coll is not None
        else None,
    }


def breakdown(st: dict) -> dict:
    """The three keys the window adds to the result line's breakdown."""
    top = sorted(((p, v) for p, v in st["by_path"].items() if p != NONE),
                 key=lambda kv: -kv[1])[:TOP]
    device = [[p, v] for p, v in top] + [[NONE,
                                          st["by_path"].get(NONE, 0.0)]]
    gaps = devtrace.gaps([(s, e) for _n, s, e, _c in st["records"]],
                         st["lo_ns"], st["hi_ns"]) if st["records"] else []
    owner = innermost(st["spans"], [(s + e) / 2 for s, e in gaps])
    idle = sorted(([st["paths"][i] if i is not None else NONE,
                    (e - s) / 1e9] for (s, e), i in zip(gaps, owner)),
                  key=lambda kv: -kv[1])[:TOP]
    syncs: dict = {}
    for _n, p, _in_run in st["syncs"]:
        syncs[p] = syncs.get(p, 0) + 1
    return {"device_spans": device, "idle_spans": idle,
            "syncs_by_span": sorted(([p, c] for p, c in syncs.items()),
                                    key=lambda kv: -kv[1])}


def below_stage_pct(st: dict) -> float | None:
    """% of busy seconds attributed to a span below the stages
    (``BELOW_STAGE``)."""
    return share(st, lambda s: s.startswith(BELOW_STAGE))


def _report(rec: dict, st: dict) -> None:
    """The window's own figures on standard error."""
    plain = rec["trace"]
    jobs = plain["jobs"][:len(plain["jobs"]) - st["jobs"]]
    plain_ms = [(j["t1"] - j["t0"]) / 1e6 for j in jobs]
    idle = (100.0 * (1 - st["busy_s"] / st["window_s"])
            if st["records"] and st["window_s"] else None)
    plain_idle = (100.0 * (1 - plain["busy_s"] / plain["window_s"])
                  if plain["records"] and plain["window_s"] else None)
    clock = st["clock"]
    print("spantrace " + json.dumps({
        "spans": len(st["spans"]),
        "job_ms": sum(st["wall_ms"]) / len(st["wall_ms"]),
        "plain_job_ms": sum(plain_ms) / len(plain_ms) if plain_ms else None,
        "idle_pct": idle, "plain_idle_pct": plain_idle,
        "below_stage_pct": below_stage_pct(st),
        "none_pct": (100.0 * st["by_path"].get(NONE, 0.0) / st["busy_s"]
                     if st["busy_s"] else None),
        "records": len(st["records"]), "no_launch": st["no_launch"],
        "other_job": st["other_job"],
        "clock_offset_us": ([c / 1e3 for c in clock] if clock else None)}),
        file=sys.stderr, flush=True)


def _extend_breakdown(bench, trace_rec: dict, st: dict) -> None:
    """Have ``bench.breakdown``, called next for this run's profile
    window, add the window's three keys; it then puts itself back."""
    orig = bench.breakdown

    def with_spans(tr):
        bench.breakdown = orig
        out = orig(tr)
        if tr is trace_rec:
            out.update(breakdown(st))
        return out

    bench.breakdown = with_spans
