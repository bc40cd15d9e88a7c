"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own and is found by name:

* ``configs/<config>.json`` (the configuration's ``file``): the
  deployment's sizes, and in ``generator`` the module of
  ``generators/`` that makes its tables on the device;
* ``traffic/<traffic>.json``: the client (a module of ``clients/``), the
  job the window repeats (a module of ``jobs/``) with its parameters, and
  the columns it reads;
* ``clients/<client>.py``: when the window submits jobs;
* ``jobs/<job>.py``: the job's context and sources (``setup``) and one
  job through the port's Dataset API to its terminal (``run``);
* ``reference/<job>.py``: the plain reference, the comparison that
  decides ``correct`` (``check``) and its control (``control``);
* ``metrics/<metric>.py``: one reader per metric, end to end or per
  layer.

Set-up (from the process's start to the first timed job) builds the
tables on the device from the seed, the job's context, and runs the
warm-up jobs.  Each job is timed on the host clock and split into spans
at its executor runs.  With ``--trace 1`` the same window runs and then a
few more jobs run under the profiler; the result line then carries the
per-layer metrics.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

# the harness's own imports, torch's among them, end here: set-up's first
# part
IMPORTED = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "dryad_tpu")
# a device operation's name in the breakdown is cut to this many characters
# (a templated kernel's full name runs to several hundred)
NAME_CHARS = 160
# jobs run before the window (the first builds the kernels in a fresh
# checkout; the second runs with the send slots the first measured), and
# jobs run under the profiler after it
WARMUP_JOBS, TRACE_JOBS = 2, 3


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that are forbidden, compared
    whole (``dryad_tpu_torch`` is not ``dryad_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(names & set(FORBIDDEN))


def load_file(path: str, name: str):
    """A module from a file under the harness, by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, overrides=None):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name, self.entry = name, cells[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[
            self.entry["config"]]
        cfg_path = os.path.join(ROOT, conf["file"])
        with open(cfg_path) as f:
            self.config = json.load(f)
        self.config.update(overrides or {})
        self.gen = part("generators", self.config["generator"])
        with open(os.path.join(HERE, "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.client = part("clients", self.traffic["client"])
        self.job = part("jobs", self.traffic["job"])
        self.reference = part("reference", self.traffic["job"])

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in this mode."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def part(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the harness."""
    return load_file(os.path.join(HERE, kind, name + ".py"),
                     f"portbench_{kind}_{name.replace('.', '_')}")


def reader(name: str):
    return part("metrics", name)


def import_port():
    """The port from this checkout, never from anywhere else."""
    import dryad_tpu_torch
    pkg = os.path.dirname(os.path.abspath(dryad_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise RuntimeError(f"dryad_tpu_torch imported from {pkg}, not from "
                           f"the checkout {ROOT}")
    return dryad_tpu_torch


class Client:
    """Runs one job at a time to its end, timed on the host clock and
    split into spans at its executor runs; the cell's client module
    decides when."""

    def __init__(self, cell: Cell, ctx, src: dict, sync):
        self.cell, self.ctx, self.src, self.sync = cell, ctx, src, sync
        self.current = None
        self.last = None        # the last job's output
        # a context whose jobs run in other processes has no executor
        # here: its jobs get no spans, stage log or host reads
        ex = self.ex = getattr(ctx, "executor", None)
        if ex is None:
            return
        run = ex.run

        def logged_run(graph, *args, **kw):
            job = self.current
            if job is not None and "t_run" not in job:
                job["t_run"] = time.perf_counter_ns()
            try:
                return run(graph, *args, **kw)
            finally:
                if job is not None:
                    job["t_ret"] = time.perf_counter_ns()
                    job["stages"].extend(ex.stage_log)

        ex.run = logged_run

    def one(self) -> dict:
        """Run one job to its end; its record."""
        cell, ex = self.cell, self.ex
        self.last = None     # the previous output is dropped first
        reads0 = ex.host_reads if ex is not None else 0
        job = {"stages": []}
        self.current = job
        job["t0"] = time.perf_counter_ns()
        job["keep"], self.last = cell.job.run(
            self.ctx, self.src, cell.traffic.get("params", {}))
        self.sync()
        job["t1"] = time.perf_counter_ns()
        self.current = None
        if ex is not None:
            job["host_reads"] = ex.host_reads - reads0
        return job


def input_rows(tables: dict) -> int:
    return sum(t["rows"] for t in tables.values())


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def trace_jobs(client: Client, n: int, device) -> dict:
    """``n`` more jobs under the profiler, with the kernels' calls
    recorded by shape: the trace part of the record."""
    from dryad_tpu_torch.ops import hopper_kernels as hk

    from portbench import devtrace, roofline

    def run_jobs():
        # a log of its own for each profile window: the calls of a window
        # the profiler dropped pair with no records
        log = roofline.ShapeLog()
        hk.capture = log
        try:
            return [client.one() for _ in range(n)], log
        finally:
            hk.capture = None

    if device.type != "cuda":
        (jobs, log), records, offset = run_jobs(), [], 0
    else:
        (jobs, log), records, offset = devtrace.profile_jobs(run_jobs,
                                                             device)
    lo, hi = jobs[0]["t0"] + offset, jobs[-1]["t1"] + offset
    return {"jobs": jobs, "records": records, "offset_ns": offset,
            "lo_ns": lo, "hi_ns": hi, "window_s": (hi - lo) / 1e9,
            "busy_s": devtrace.union_seconds(
                [(s, e) for _n, s, e in records], lo, hi) / 1e9,
            "least": roofline.least_by_kernel(log)}


def breakdown(trace: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host span they fall in."""
    from portbench import devtrace
    by_name: dict = {}
    for name, s, e in trace["records"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = [(n[:NAME_CHARS], v) for n, v in ops]
    off = trace["offset_ns"]
    spans = []
    for i, j in enumerate(trace["jobs"]):
        t_run, t_ret = j.get("t_run", j["t1"]), j.get("t_ret", j["t1"])
        spans += [(j["t0"] + off, t_run + off, f"job{i}.plan"),
                  (t_run + off, t_ret + off, f"job{i}.execute"),
                  (t_ret + off, j["t1"] + off, f"job{i}.terminal")]
    idle = []
    for s, e in devtrace.gaps([(a, b) for _n, a, b in trace["records"]],
                              trace["lo_ns"], trace["hi_ns"]):
        mid = (s + e) / 2
        host = next((n for a, b, n in spans if a <= mid < b), "between")
        idle.append([host, (e - s) / 1e9])
    idle.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle[:10]}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run: set-up, the window, the traced jobs, the check.  Returns
    the result line's object."""
    port = import_port()
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)
    t_tables = time.perf_counter()
    tables = cell.gen.make(cell.config, cell.traffic["reads"], seed, device)
    sync()
    t_warm = time.perf_counter()
    ctx, src = cell.job.setup(port, cell.config, tables, device)
    client = Client(cell, ctx, src, sync)
    for _ in range(WARMUP_JOBS):
        client.one()
    sync()
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    jobs = cell.client.window(client.one, seconds, cell.traffic)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    traced = trace_jobs(client, TRACE_JOBS, device) if trace else None
    rec = {"jobs": jobs, "rows_per_job": input_rows(tables),
           "terminal": cell.job.TERMINAL, "setup_s": setup_s,
           "peak_bytes": peak, "trace": traced}
    result = {"metrics": {}}
    for m in cell.metrics(trace):
        v = reader(m["name"]).read(rec)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} has no "
                               f"value")
    # the check: after the window, the peak read, the program's state freed
    # (the traced jobs are judged too; the last job's output is the last
    # traced job's in a traced run)
    last = client.last
    done = jobs + (traced["jobs"] if traced else [])
    del client, ctx, src
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = check(cell, tables, done, last)
    result.update(
        correct=bool(all(checks[k]["value"] <= checks[k]["limit"]
                         for k in checks) and not failed),
        attempted=len(done), failed=failed)
    result["device"] = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=rec["trace"]["busy_s"],
                                window_s=rec["trace"]["window_s"])
        result["breakdown"] = breakdown(rec["trace"])
    # set-up's parts: the harness's imports (torch's), the port's import
    # and the check for devices, the tables, the context and warm-up jobs
    imported = max(IMPORTED, t_start)
    result["setup_parts_s"] = {"imports": imported - t_start,
                               "port": t_tables - imported,
                               "tables": t_warm - t_tables,
                               "warmup": setup_s - (t_warm - t_start)}
    result["card"] = card_line() if on_card else "cpu"
    result["checks"] = checks
    return result


def check(cell: Cell, tables: dict, jobs: list, last):
    """The numbers compared with their limits, and the jobs that failed,
    from the cell's reference."""
    ref = cell.reference
    nums, failed = ref.check(tables, cell.traffic.get("params", {}), jobs,
                             last)
    return ({k: {"value": nums[k], "limit": ref.LIMITS[k]}
             for k in ref.LIMITS}, failed)


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}: no result",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
