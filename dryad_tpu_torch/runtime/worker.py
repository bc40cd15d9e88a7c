"""Per-node worker service: ``python -m dryad_tpu_torch.runtime.worker``
— the port of ``dryad_tpu/runtime/worker.py``.

The counterpart of the reference's per-node daemon
(ProcessService/ProcessService.cs:389 — a process the submission layer
starts on every machine, which then executes vertex commands from the
GM).  A worker connects back to the driver's control socket, answers its
HMAC challenge, and serves commands until told to stop:

* ``ping`` / ``stop``;
* ``run_task``: one farm task — a whole plan over the task's own sources
  on the worker's OWN device (``--device``, the CUDA card by default;
  ``--devices-per-process`` logical partitions there), with no
  collective across processes.  One persistent executor serves every
  task (its slot feedback and probe caches carry over), its run events
  come back in the reply, and so do the kernel launches the task made
  (``launches``, per kernel: the driver cannot see another process's
  counters).  A failure replies with the flight recorder's forensics
  bundle (``obs/flight.py``);
* ``run``: one gang SPMD job (``runtime/exec_common.execute_plan``):
  every worker of the gang runs the same plan over its own
  ``--devices-per-process`` partitions of the gang's, the exchanges
  crossing processes through the ``torch.distributed`` gloo group the
  worker joined at start (``--coordinator``, the driver's free port;
  rank = ``--process-id``, world = ``--num-processes``).  While the job
  runs a heartbeat thread sends ``{"hb": pid}`` frames every
  ``hb_every`` seconds, which the driver's wedge watchdog reads
  (``runtime/cluster.py``).  The reply carries this worker's rows (the
  parallel collect), the job's extras, the kernel ``launches``, the
  staged collectives' totals (``staged``, ``parallel/mesh.STAGED``) and
  the seconds this process has spent building kernels (``compile_s``: a
  CUDA worker builds every kernel at start, in parallel, where its copy
  of the sources — a fresh checkout, a staged root — has none built).  A
  job that touches a resident token this worker lost replies with the
  token in ``missing_token``.  A ``--standalone`` (elastic) worker
  joined no gang and refuses ``run``.

Several workers may share one card: each holds its own CUDA context and
they time-share the device.
"""

from __future__ import annotations

import argparse
import os
import socket
import threading
import traceback

def task_executor(device, nparts: int):
    """The executor a worker runs its farm tasks on: one for the process
    (its slot feedback and probe caches carry over from task to task),
    on ``nparts`` logical partitions of ``device``.  One farm task is a
    slice of the driver's job, not a job, so its Run emits no job_done
    (``exec/recovery.py``)."""
    from dryad_tpu_torch.exec.executor import Executor
    from dryad_tpu_torch.parallel.mesh import Mesh
    ex = Executor(Mesh(device, nparts))
    ex._emit_job_done = False
    return ex


def run_task(msg: dict, ex, fn_modules=(), ev=None, runs=None):
    """Run one task envelope (``plan``, ``sources``, ``config``; a
    ``run_task`` message or a forensics bundle) on ``ex``; returns the
    output PData.  ``ev`` is the run's event sink; ``runs``, a list,
    gets the Run appended."""
    import time

    from dryad_tpu_torch.plan.serialize import graph_from_json
    from dryad_tpu_torch.runtime.shiplan import resolve_fn_table
    from dryad_tpu_torch.runtime.sources import build_source
    if msg.get("delay_s"):
        time.sleep(msg["delay_s"])
    ex.apply_config(msg.get("config"))
    fn_table = resolve_fn_table(msg["plan"], fn_modules)
    verify = ex.config.store_verify_checksums
    sources = {key: build_source(spec, ex.mesh, verify=verify)
               for key, spec in (msg.get("sources") or {}).items()}
    graph = graph_from_json(msg["plan"], fn_table=fn_table,
                            sources=sources)
    return ex.run(graph, event_log=ev, runs=runs)


def _task_reply(msg: dict, ex, fn_modules, ev) -> dict:
    """A successful task's reply fields: its host ``table``, its kernel
    ``launches`` and its adaptive ``rewrites``."""
    from dryad_tpu_torch.exec.data import (maybe_shrink_for_collect,
                                           pdata_to_host)
    from dryad_tpu_torch.ops import hopper_kernels as hk
    # this process runs one task at a time: the counters' change over
    # the task is the task's own launches
    before = dict(hk.launches)
    runs: list = []
    pd = run_task(msg, ex, fn_modules, ev, runs)
    out = {"table": pdata_to_host(maybe_shrink_for_collect(pd, ex.config))}
    after = dict(hk.launches)
    out["launches"] = {k: after[k] - before[k] for k in after}
    # adaptive rewrites applied inside this task's run (JobConfig.adaptive
    # rides the shipped config); the farm folds the count into task_done
    if runs[0].rewrites:
        out["rewrites"] = runs[0].rewrites
    return out


def _tag_missing_token(reply: dict, exc: BaseException) -> None:
    """Copy a MissingResidentToken's token into the error reply as
    structured data (the driver's resident healing reads this field, not
    the traceback text)."""
    from dryad_tpu_torch.runtime.sources import MissingResidentToken
    if isinstance(exc, MissingResidentToken):
        reply["missing_token"] = exc.token


def _join_gang(args, device):
    """The gang mesh: this worker's ``--devices-per-process`` partitions
    of the gang's ``--num-processes`` x that, in a gloo process group
    rendezvoused at the driver's ``--coordinator`` port.  Its axes are
    ``(dcn, dp)``: the process boundary is ``dcn`` (the rank), the
    worker's own partitions ``dp``; one process is ``(dp,)``."""
    from dryad_tpu_torch.parallel.mesh import HOST_AXIS, PARTITION_AXIS, Mesh
    world, dpp = args.num_processes, args.devices_per_process
    if world > 1:
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://{args.coordinator}",
            rank=args.process_id, world_size=world)
    return Mesh(device, dpp * world, rank=args.process_id, world=world,
                axes=((HOST_AXIS, world), (PARTITION_AXIS, dpp))
                if world > 1 else ())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                      "dryad_tpu_torch.runtime.worker")
    ap.add_argument("--control", required=True,
                    help="the driver's control address, host:port")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="logical partitions of the worker's mesh")
    ap.add_argument("--fn-module", action="append", default=[])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the worker runs its tasks on "
                         "(cuda raises without CUDA)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the gang's gloo rendezvous")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="the gang's worker count (the gloo world)")
    ap.add_argument("--standalone", action="store_true",
                    help="elastic worker: joins no gang, serves farm "
                         "tasks, refuses gang jobs (run)")
    args = ap.parse_args(argv)

    # worker identity for subsystems that attribute per worker
    os.environ["DRYAD_WORKER_ID"] = str(args.process_id)
    from dryad_tpu_torch.parallel.mesh import resolve_device
    from dryad_tpu_torch.runtime import protocol
    device = resolve_device(args.device)
    if device.type == "cuda":
        # every kernel from this copy's sources at once (one nvcc each,
        # in parallel; nothing to do where they are built already), before
        # a job's first launch would build them one by one
        from dryad_tpu_torch.ops import _build
        _build.build()
    ex = task_executor(device, args.devices_per_process)
    gang = None if args.standalone else _join_gang(args, device)

    # snapshot the spawning driver's pid NOW — by the time a severed
    # socket is observed the kernel may already have reparented us, and a
    # late getppid() would capture pid 1 and linger forever
    parent_pid = os.getppid()
    host, port = args.control.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    # answer the driver's HMAC challenge BEFORE any pickled traffic; the
    # secret arrives out-of-band (the process environment)
    protocol.client_authenticate(sock, protocol.load_secret_from_env())
    protocol.send_msg(sock, {"hello": args.process_id,
                             "devices": args.devices_per_process})
    send_lock = threading.Lock()   # the reply and the heartbeat thread

    def _send_reply(obj) -> bool:
        """Send a control reply; on a severed socket (the driver retired
        this worker, runtime/cluster.py retire_worker) return False
        instead of crashing the process."""
        try:
            with send_lock:
                protocol.send_msg(sock, obj)
            return True
        except OSError:
            return False

    lost_control = False
    while True:
        try:
            msg = protocol.recv_msg(sock)
        except (EOFError, OSError):
            lost_control = True
            break
        cmd = msg.get("cmd")
        if cmd == "stop":
            _send_reply({"bye": args.process_id})
            break
        if cmd == "ping":
            # echo the job tag: a pong proves the worker has DRAINED all
            # prior work queued on its socket (the farm's idle gate)
            if not _send_reply({"pong": args.process_id,
                                "job": msg.get("job")}):
                lost_control = True
                break
            continue
        if cmd == "run_task":
            reply = _serve_task(msg, args, ex)
        elif cmd == "run" and gang is None:
            # a mid-life joiner has no gang membership: gang jobs need a
            # gang restart, farm tasks do not
            reply = {"ok": False, "pid": args.process_id,
                     "job": msg.get("job"),
                     "error": "standalone (elastic) worker cannot join "
                              "gang SPMD jobs"}
        elif cmd == "run":
            reply = _serve_job(msg, args, gang, _send_reply)
        else:
            reply = {"ok": False, "pid": args.process_id,
                     "job": msg.get("job"),
                     "error": f"unknown command {cmd!r}"}
        if not _send_reply(reply):
            lost_control = True
            break
    sock.close()
    if lost_control:
        # the driver retired us (severed socket): linger until the
        # driver's restart kills us — or until we are orphaned — as the
        # JAX worker does (there, exiting would take its jax.distributed
        # peers down; here it keeps the two lifecycles the same)
        import time
        while os.getppid() == parent_pid:
            time.sleep(1.0)
        return 0
    if gang is not None and gang.gang:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def _heartbeat(send, pid: int, job, interval: float,
               stop: threading.Event) -> None:
    """Progress frames while a gang job runs: the driver's watchdog tells
    a wedged worker (a frozen process: the beats stop) from a busy one
    (this thread beats even while the job blocks in a collective)."""
    while not stop.wait(interval):
        if not send({"hb": pid, "job": job}):
            return


def _serve_job(msg: dict, args, mesh, send) -> dict:
    """One ``run``: the gang job with heartbeats, its spans (when the
    driver traces), its resource sampler, and forensics on error."""
    import time

    from dryad_tpu_torch.obs import flight as _flight
    from dryad_tpu_torch.obs import profile as _profile
    from dryad_tpu_torch.obs import trace as _trace
    from dryad_tpu_torch.ops import _build
    from dryad_tpu_torch.ops import hopper_kernels as hk
    from dryad_tpu_torch.parallel import mesh as _mesh
    from dryad_tpu_torch.runtime import protocol
    from dryad_tpu_torch.runtime.exec_common import execute_plan
    from dryad_tpu_torch.runtime.shiplan import resolve_fn_table

    events: list = []

    def _ev(e, _events=events):
        # the emission time, as in run_task
        e = dict(e, ts=round(time.time(), 4))
        _events.append(e)
        _flight.record(e)

    reply: dict = {"ok": True, "pid": args.process_id,
                   "job": msg.get("job")}
    stop = threading.Event()
    hb_every = float(msg.get("hb_every") or 0)
    beat = None
    if hb_every > 0:
        beat = threading.Thread(target=_heartbeat, daemon=True, args=(
            send, args.process_id, msg.get("job"), hb_every, stop))
        beat.start()
    tctx = protocol.extract_trace(msg)
    evs = _trace.leveled(_ev, 2 if tctx is not None else 0)
    sampler = _profile.start(
        _ev if tctx is not None else None,
        getattr(msg.get("config"), "resource_sample_s", 0.0) or 0.0,
        device=mesh.device, worker_pid=args.process_id,
        job=msg.get("job"))
    before, staged = dict(hk.launches), dict(_mesh.STAGED)
    try:
        fn_table = resolve_fn_table(msg["plan"], args.fn_module)
        collect = msg.get("collect", True)
        with _trace.tracing(evs, tctx):
            table, extras = execute_plan(
                msg["plan"], fn_table, msg["sources"], mesh,
                event_log=evs, store_path=msg.get("store_path"),
                store_partitioning=msg.get("store_partitioning"),
                collect=collect, config=msg.get("config"),
                keep_token=msg.get("keep_token"),
                release=tuple(msg.get("release") or ()),
                store_compression=msg.get("store_compression"))
        reply.update(extras)
        if collect == "count":
            if args.process_id == 0:
                reply["table"] = table
        elif collect:
            # every worker ships its own partitions' rows
            reply["table_part"] = table
        after = dict(hk.launches)
        reply["launches"] = {k: after[k] - before[k] for k in after}
        reply["staged"] = {k: _mesh.STAGED[k] - staged[k]
                           for k in _mesh.STAGED}
        reply["compile_s"] = _build.compile_seconds()
        # test hook "pid:seconds": delay ONE worker's reply while its
        # heartbeats keep flowing (the watchdog's busy-but-alive case)
        spec = os.environ.get("DRYAD_TEST_REPLY_DELAY", "")
        if spec:
            pid, _, secs = spec.partition(":")
            if int(pid) == args.process_id:
                time.sleep(float(secs))
    except Exception as e:
        reply = {"ok": False, "pid": args.process_id,
                 "job": msg.get("job"), "error": traceback.format_exc()}
        _tag_missing_token(reply, e)
        try:
            protocol.attach_forensics(reply, _flight.capture_bundle(
                msg, e, kind="job", worker=args.process_id,
                fn_modules=args.fn_module, events=events,
                device=mesh.device.type, nparts=mesh.local_nparts))
        except Exception:
            pass
    finally:
        _profile.stop(sampler)
        stop.set()
        if beat is not None:
            beat.join(timeout=5)
    reply["events"] = events
    return reply


def _serve_task(msg: dict, args, ex) -> dict:
    """One ``run_task``: the task's spans (when the driver traces), its
    resource sampler, the flight ring, and forensics on error."""
    import time

    from dryad_tpu_torch.obs import flight as _flight
    from dryad_tpu_torch.obs import profile as _profile
    from dryad_tpu_torch.obs import trace as _trace
    from dryad_tpu_torch.runtime import protocol

    reply = {"ok": True, "pid": args.process_id,
             "task": msg.get("task"), "job": msg.get("job")}
    events: list = []

    def _ev(e, _events=events):
        # stamp the emission time HERE: the driver forwards these only
        # after the reply, and a late stamp would skew every timestamp
        # by the task wall
        e = dict(e, ts=round(time.time(), 4))
        _events.append(e)
        # the flight ring keeps recent events across TASKS, so a later
        # failure's forensics bundle carries the lead-up
        _flight.record(e)

    # adopt the driver's trace context for this task only; its presence
    # carries the driver's tracing verdict, so an untraced driver costs
    # zero span work here, and the resource sampler follows it too
    tctx = protocol.extract_trace(msg)
    evs = _trace.leveled(_ev, 2 if tctx is not None else 0)
    sampler = _profile.start(
        _ev if tctx is not None else None,
        getattr(msg.get("config"), "resource_sample_s", 0.0) or 0.0,
        device=ex.mesh.device, worker_pid=args.process_id,
        task=msg.get("task"))
    try:
        with _trace.tracing(evs, tctx), \
                _trace.span(f"task {msg.get('task')}", "task",
                            task=msg.get("task"), job=msg.get("job"),
                            worker_pid=args.process_id):
            reply.update(_task_reply(msg, ex, args.fn_module, evs))
    except Exception as e:
        reply = {"ok": False, "pid": args.process_id,
                 "task": msg.get("task"), "job": msg.get("job"),
                 "error": traceback.format_exc()}
        # ship the flight recorder's forensics bundle with the error: the
        # driver persists it and `python -m dryad_tpu_torch.obs replay`
        # reproduces this failure locally.  Best-effort — forensics must
        # never mask the error
        try:
            protocol.attach_forensics(reply, _flight.capture_bundle(
                msg, e, kind="task", worker=args.process_id,
                fn_modules=args.fn_module, events=events,
                device=ex.mesh.device.type, nparts=ex.nparts))
        except Exception:
            pass
    finally:
        _profile.stop(sampler)
    reply["events"] = events
    return reply


if __name__ == "__main__":
    raise SystemExit(main())
