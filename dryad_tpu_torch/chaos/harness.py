"""The chaos scenario driver (see package docstring) — the port of
``dryad_tpu/chaos/harness.py``.

``run_scenario`` is the whole arc: spawn a victim daemon process on
``device``, wait until its target job is past ``plan.kill_after_spills``
settled stages, SIGKILL it (a kernel may be in flight: its CUDA context
dies with it), optionally tear the journal tail, start a successor
daemon over the same service dir on the same device in this process,
drain the recovered fleet, and return a verdict dict with the invariant
checks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional

from dryad_tpu_torch.chaos import faults, invariants
from dryad_tpu_torch.chaos.plan import FaultPlan
from dryad_tpu_torch.runtime.cluster import package_env

__all__ = ["run_scenario"]


def _wait_for(pred, timeout: float, interval: float = 0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    return None


def _event_count(path: str, kind: str) -> int:
    try:
        with open(path) as f:
            return sum(1 for line in f
                       if json.loads(line).get("event") == kind)
    except (OSError, ValueError):
        return 0


def run_scenario(seed: int = 0, workdir: Optional[str] = None,
                 timeout: float = 300.0, device="cuda") -> Dict[str, Any]:
    """One full kill-and-recover scenario on ``device`` (the victim's
    and its successor's).  Returns the report dict (``report["ok"]`` is
    the overall verdict); raises only on harness bugs, never on an
    invariant violation."""
    from dryad_tpu_torch.parallel.mesh import resolve_device
    device = resolve_device(device).type     # no CUDA: raise, spawn none
    plan = FaultPlan(seed)
    d = workdir or tempfile.mkdtemp(prefix="dryad-chaos-")
    os.makedirs(d, exist_ok=True)
    report: Dict[str, Any] = {"seed": seed, "plan": plan.to_json(),
                              "workdir": d, "device": device, "ok": False}

    # -- phase 1: the victim daemon, killed for real ------------------------
    with open(os.path.join(d, "victim.log"), "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dryad_tpu_torch.chaos._victim",
             "--dir", d, "--seed", str(seed), "--device", device],
            stdout=logf, stderr=subprocess.STDOUT, env=package_env())
        try:
            mpath = os.path.join(d, "manifest.json")
            man = _wait_for(
                lambda: (os.path.exists(mpath) or None)
                and json.load(open(mpath)), timeout)
            if man is None:
                raise RuntimeError(
                    f"victim never wrote a manifest (victim.log in {d})")
            report["manifest"] = {k: man[k] for k in
                                  ("running", "queued", "standing")}
            spills = _wait_for(
                lambda: _event_count(man["target_events"],
                                     "stage_spilled")
                >= plan.kill_after_spills or None, timeout)
            report["spills_at_kill"] = _event_count(
                man["target_events"], "stage_spilled")
            if spills is None:
                raise RuntimeError("target job never spilled a stage")
        finally:
            faults.sigkill(proc.pid)
            proc.wait()
    report["killed_pid"] = proc.pid

    # -- phase 2: optional torn write over the journal tail -----------------
    jpath = os.path.join(man["durable_dir"], "journal.jsonl")
    if plan.torn_tail:
        faults.torn_tail(jpath, plan.torn_bytes)
    report["torn_injected"] = plan.torn_tail

    # -- phase 3: the successor daemon adopts and drains --------------------
    from dryad_tpu_torch.chaos._victim import catalog_for
    from dryad_tpu_torch.service.daemon import JobService
    from dryad_tpu_torch.service.tenancy import ServiceConfig
    svc = JobService(
        ServiceConfig(service_dir=man["service_dir"], slots=1,
                      durable_spill=True),
        device=device, catalog=catalog_for(man["stores"]))
    try:
        report["recovery"] = svc.recovery
        # the injected faults become part of the successor's forensic
        # record — a post-hoc reader of the service log sees WHY the
        # journal shows a dirty epoch
        svc.log({"event": "chaos_fault", "fault": "sigkill",
                 "pid": proc.pid, "seed": seed,
                 "spills_at_kill": report["spills_at_kill"]})
        if plan.torn_tail:
            svc.log({"event": "chaos_fault", "fault": "torn_tail",
                     "bytes": plan.torn_bytes, "seed": seed})
        results: Dict[str, Any] = {}
        for jid in (man["running"], man["queued"]):
            row = svc.wait(jid, timeout=timeout)
            report.setdefault("jobs", {})[jid] = {
                "state": row["state"], "error": row.get("error"),
                "archived": bool(row.get("archived"))}
            if row["state"] == "done" and "result" in row:
                results[jid] = row["result"]
        # the resumed target must have RESTORED its settled stages, not
        # recomputed them (that is what "durable" buys)
        restored = _event_count(man["target_events"], "stage_restored")
        report["stages_restored"] = restored
        # oracle: the same query, fresh, on the successor
        oracle = svc.wait(svc.submit_sql(man["query"], tenant="alice"),
                          timeout=timeout)["result"]
        sq = svc.standing.get(man["standing"])
        report["standing_recovered"] = (sq is not None
                                        and sq.state == "running")
    finally:
        svc.close()

    # -- verdict ------------------------------------------------------------
    inv = invariants.check_invariants(man["durable_dir"],
                                      results=results, oracle=oracle)
    report["invariants"] = inv
    report["all_terminal"] = all(
        j["state"] in ("done", "failed", "cancelled")
        for j in report["jobs"].values())
    report["ok"] = bool(
        inv["ok"] and report["all_terminal"]
        and report["standing_recovered"]
        and all(j["state"] == "done"
                for j in report["jobs"].values())
        # past-a-settled-stage proof: the target either restored its
        # spilled stages on resume, or had already finished pre-kill
        and (restored >= 1 or report["spills_at_kill"] == 0
             or report["jobs"][man["running"]]["archived"]))
    return report
