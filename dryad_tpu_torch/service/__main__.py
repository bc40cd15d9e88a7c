"""Job-service CLI — ``python -m dryad_tpu_torch.service <cmd> ...``, the
port of ``dryad_tpu/service/__main__.py``.

* ``serve``    start the persistent daemon + HTTP front end and block
               (Ctrl-C drains and stops): the in-process fleet on the
               CUDA card, or on the CPU with ``--device cpu``;
               ``--cluster N`` runs the fleet on N worker processes
               (``--devices-per-process`` partitions each, on
               ``--device``)
* ``submit``   submit a registered app — or a SQL query over the
               daemon's catalog with ``--sql "SELECT ..."`` (serve
               ``--catalog cat.json`` registers the tables) — to a
               running daemon; ``--wait`` blocks for the result
* ``status``   one job's row (``--result`` inlines the result)
* ``wait``     block until a job is terminal; prints the final row
* ``cancel``   cancel a queued/running job
* ``list``     all jobs the daemon knows
* ``tenants``  fair-share snapshot (slot-seconds, running, failures)
* ``slo``      per-tenant SLO attainment + error-budget burn rate
* ``standing`` all registered standing queries (``SELECT ... EMIT
               EVERY n`` submissions; cancel one with ``cancel <id>``,
               follow its refresh deltas with ``events <id>``)
* ``events``   follow one job's live event stream (SSE; ``--after N``
               resumes at a cursor) until the job is terminal

Exit codes: 0 success; 1 the operation failed (job failed / unknown
job); 2 typed rejection (the stable code is printed — DTA91x admission
walls, DTA911 meaning backpressure/resubmit later, or a DTA3xx SQL
compile error with its line:column findings); 3 malformed input.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fail(msg: str, rc: int = 3) -> int:
    print(f"dryad_tpu_torch.service: {msg}", file=sys.stderr)
    return rc


def _client(args):
    from dryad_tpu_torch.service.http import Client
    return Client(args.url)


def _cmd_serve(args) -> int:
    from dryad_tpu_torch.service.daemon import JobService
    from dryad_tpu_torch.service.http import serve
    from dryad_tpu_torch.service.tenancy import ServiceConfig
    tenants = {}
    if args.tenants:
        try:
            with open(args.tenants) as f:
                tenants = ServiceConfig.tenants_from_json(json.load(f))
        except (OSError, ValueError, TypeError) as e:
            return _fail(f"cannot load --tenants {args.tenants!r}: {e}")
    cluster = None
    if args.cluster:
        from dryad_tpu_torch.runtime.cluster import LocalCluster
        cluster = LocalCluster(
            n_processes=args.cluster,
            devices_per_process=args.devices_per_process,
            device=args.device)
    cfg = ServiceConfig(service_dir=args.dir, slots=args.slots,
                        tenants=tenants,
                        task_timeout_s=args.task_timeout_s,
                        catalog_path=args.catalog)
    svc = JobService(cfg, cluster=cluster, own_cluster=cluster is not None,
                     device=args.device)
    srv, port = serve(svc, port=args.port)
    print(f"dryad job service on http://127.0.0.1:{port}/ "
          f"(fleet: {'cluster' if cluster else 'in-process'}, "
          f"device: {args.device}, slots: {svc.slots}, dir: {svc.root})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        svc.close()
    return 0


def _print_row(row: dict) -> int:
    print(json.dumps(row, indent=2, default=str))
    return 0 if row.get("state") in ("done", "queued", "running") else 1


def _cmd_submit(args) -> int:
    from dryad_tpu_torch.service.tenancy import ServiceRejected
    if bool(args.app) == bool(args.sql):
        return _fail("submit needs an app name OR --sql \"QUERY\"")
    try:
        params = json.loads(args.params) if args.params else {}
    except ValueError as e:
        return _fail(f"--params is not JSON: {e}")
    c = _client(args)
    try:
        if args.sql:
            jid = c.submit_sql(args.sql, tenant=args.tenant,
                               priority=args.priority)
        else:
            jid = c.submit(args.app, params=params, tenant=args.tenant,
                           priority=args.priority)
    except ServiceRejected as e:
        return _fail(f"rejected [{e.code}]: {e}", rc=2)
    if not args.wait:
        print(jid)
        return 0
    return _print_row(c.wait(jid, timeout=args.timeout))


def _cmd_status(args) -> int:
    return _print_row(_client(args).status(args.job, result=args.result))


def _cmd_wait(args) -> int:
    return _print_row(_client(args).wait(args.job, timeout=args.timeout))


def _cmd_cancel(args) -> int:
    ok = _client(args).cancel(args.job)
    print("cancelled" if ok else "already terminal")
    return 0 if ok else 1


def _cmd_list(args) -> int:
    for row in _client(args).jobs():
        print(json.dumps(row, default=str))
    return 0


def _cmd_tenants(args) -> int:
    print(json.dumps(_client(args).tenants(), indent=2))
    return 0


def _cmd_slo(args) -> int:
    print(json.dumps(_client(args).slo(), indent=2))
    return 0


def _cmd_standing(args) -> int:
    for row in _client(args).standing():
        print(json.dumps(row, default=str))
    return 0


def _cmd_events(args) -> int:
    try:
        for e in _client(args).stream_events(args.job,
                                             after=args.after):
            print(json.dumps(e, default=str), flush=True)
    except RuntimeError as e:     # unknown job -> 404
        return _fail(str(e), rc=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.service",
        description="multi-tenant dryad_tpu_torch job service")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the daemon + HTTP front end")
    s.add_argument("--dir", required=True,
                   help="service state root (jobs/, history/, cache/)")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--slots", type=int, default=2,
                   help="in-process fleet concurrency (no --cluster)")
    s.add_argument("--cluster", type=int, default=0, metavar="N",
                   help="run an N-process LocalCluster worker fleet")
    s.add_argument("--devices-per-process", type=int, default=2,
                   help="logical partitions of each worker (--cluster)")
    s.add_argument("--task-timeout-s", type=float, default=600.0)
    s.add_argument("--device", default="cuda",
                   help="the device the fleet runs on, the workers' with "
                        "--cluster (default cuda; cpu runs the kernels' "
                        "plain versions)")
    s.add_argument("--tenants", default=None,
                   help='JSON file {"tenant": {"share": 2, ...}, ...}')
    s.add_argument("--catalog", default=None,
                   help="serialized sql.Catalog JSON: the tables "
                        "POST /sql and `submit --sql` queries run over")
    s.set_defaults(fn=_cmd_serve)

    def _url(p):
        p.add_argument("--url", required=True,
                       help="daemon base URL (http://127.0.0.1:PORT)")

    s = sub.add_parser("submit",
                       help="submit a registered app or a --sql query")
    _url(s)
    s.add_argument("app", nargs="?", default=None)
    s.add_argument("--sql", default=None, metavar="QUERY",
                   help="submit a SQL query over the daemon's catalog "
                        "instead of a registered app (typed DTA3xx "
                        "rejection on compile errors, exit 2)")
    s.add_argument("--params", default=None, help="JSON object")
    s.add_argument("--tenant", default="default")
    s.add_argument("--priority", type=int, default=0)
    s.add_argument("--wait", action="store_true")
    s.add_argument("--timeout", type=float, default=300.0)
    s.set_defaults(fn=_cmd_submit)

    s = sub.add_parser("status", help="one job's status row")
    _url(s)
    s.add_argument("job")
    s.add_argument("--result", action="store_true")
    s.set_defaults(fn=_cmd_status)

    s = sub.add_parser("wait", help="block until a job is terminal")
    _url(s)
    s.add_argument("job")
    s.add_argument("--timeout", type=float, default=300.0)
    s.set_defaults(fn=_cmd_wait)

    s = sub.add_parser("cancel", help="cancel a queued/running job")
    _url(s)
    s.add_argument("job")
    s.set_defaults(fn=_cmd_cancel)

    s = sub.add_parser("list", help="all jobs")
    _url(s)
    s.set_defaults(fn=_cmd_list)

    s = sub.add_parser("tenants", help="fair-share snapshot")
    _url(s)
    s.set_defaults(fn=_cmd_tenants)

    s = sub.add_parser("slo", help="per-tenant SLO attainment + burn")
    _url(s)
    s.set_defaults(fn=_cmd_slo)

    s = sub.add_parser("standing",
                       help="all registered standing queries")
    _url(s)
    s.set_defaults(fn=_cmd_standing)

    s = sub.add_parser("events",
                       help="follow one job's live event stream (SSE)")
    _url(s)
    s.add_argument("job")
    s.add_argument("--after", type=int, default=0,
                   help="resume at this event cursor (default 0)")
    s.set_defaults(fn=_cmd_events)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except OSError as e:          # connection refused etc.
        return _fail(str(e), rc=1)


if __name__ == "__main__":
    sys.exit(main())
