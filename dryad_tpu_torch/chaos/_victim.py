"""The chaos victim: a real daemon process the harness SIGKILLs — the
port of ``dryad_tpu/chaos/_victim.py``.

Builds a small star-schema dataset (the FaultPlan's sizes), starts a
durable ``JobService`` over ``--dir`` on ``--device`` (the CUDA card by
default), submits a standing query plus two multi-stage one-shot join
jobs (slots=1, so one runs while one queues), writes a manifest for the
harness, and then waits to be killed.  Everything it does is the
production submission path — the only test-only thing here is that it
never exits on its own.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from dryad_tpu_torch import sql
from dryad_tpu_torch.api.dataset import Context
from dryad_tpu_torch.chaos.plan import FaultPlan
from dryad_tpu_torch.service.daemon import JobService
from dryad_tpu_torch.service.tenancy import ServiceConfig
from dryad_tpu_torch.utils.atomic import atomic_write_json

# three stores -> the 3-way join lowers to THREE stages, so there are
# real interior stage boundaries for the kill to land between
QUERY = ("SELECT a.k, SUM(a.v + b.w + c.u) AS s FROM a "
         "JOIN b ON a.k = b.k JOIN c ON a.k = c.k "
         "GROUP BY a.k ORDER BY s DESC LIMIT 16")


def build_stores(root: str, plan: FaultPlan, device="cuda") -> dict:
    ctx = Context(device=device, install_trace=False)
    n, keys = plan.store_rows, plan.store_keys
    paths = {name: os.path.join(root, "stores", name)
             for name in ("a", "b", "c")}
    ctx.from_columns({"k": (np.arange(n) % keys).astype(np.int32),
                      "v": np.arange(n, dtype=np.int32)}
                     ).to_store(paths["a"])
    ctx.from_columns({"k": np.arange(keys, dtype=np.int32),
                      "w": (np.arange(keys) * 3).astype(np.int32)}
                     ).to_store(paths["b"])
    ctx.from_columns({"k": np.arange(keys, dtype=np.int32),
                      "u": (np.arange(keys) * 7).astype(np.int32)}
                     ).to_store(paths["c"])
    return paths


def catalog_for(paths: dict) -> sql.Catalog:
    cat = sql.Catalog()
    for name, p in paths.items():
        cat.register_store(name, p)
    return cat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    plan = FaultPlan(args.seed)

    paths = build_stores(args.dir, plan, args.device)
    svc = JobService(
        ServiceConfig(service_dir=os.path.join(args.dir, "svc"),
                      slots=1, durable_spill=True),
        device=args.device, catalog=catalog_for(paths))
    standing_id = svc.submit_sql(
        f"SELECT k, SUM(v) AS s FROM a GROUP BY k "
        f"EMIT EVERY {plan.standing_period_s}", tenant="carol")
    running = svc.submit_sql(QUERY, tenant="alice")
    queued = svc.submit_sql(QUERY, tenant="bob")

    atomic_write_json(os.path.join(args.dir, "manifest.json"), {
        "pid": os.getpid(), "plan": plan.to_json(), "query": QUERY,
        "stores": paths, "service_dir": svc.root, "device": args.device,
        "durable_dir": os.path.join(svc.root, "durable"),
        "standing": standing_id, "running": running, "queued": queued,
        "target_events": os.path.join(svc.jobs[running].dir,
                                      "events.jsonl")})
    while True:                  # the harness ends this process, not us
        time.sleep(0.5)


if __name__ == "__main__":
    raise SystemExit(main())
