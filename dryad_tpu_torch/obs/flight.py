"""Failure forensics: flight recorder + reproducible local task replay —
the port of ``dryad_tpu/obs/flight.py``.

The reference's operability story leaned on two properties: Artemis
could explain a failure from the vertex logs after the fact, and
deterministic vertex re-execution meant any failed vertex could be
re-run in isolation for debugging (SURVEY.md §3.5).  This module is
both halves:

* **Flight recorder** — every worker keeps a bounded ring of its recent
  events (:func:`record` is called from the worker's event path, so
  spans, stage lifecycle, and resource samples from PRIOR tasks are
  all in the ring when a later task dies).

* **Forensics bundle** — on task failure the worker captures one
  self-contained artifact (:func:`capture_bundle`): the task envelope
  (plan JSON + source specs + config), content digests of the inputs,
  the exception with its traceback, the event ring, and the worker's
  device type and partition count (where the JAX package records its
  platform and device count).  The bundle rides the normal error reply
  (``runtime/protocol.FORENSICS``); the driver persists it
  (:func:`persist_bundle`, ``runtime/farm.py``, the job service's
  cluster fleet) and points at it from the raised error and a
  ``task_forensics`` event.

* **Local replay** — ``python -m dryad_tpu_torch.obs replay <bundle>``
  (:func:`replay_bundle`) re-executes that one task in-process from the
  recorded envelope, on the recorded device type unless ``--device``
  says otherwise.  Stages are deterministic by construction, so the
  remote exception reproduces locally (``--raise`` re-raises instead of
  printing the verdict).

Bundles are pickle files (the same codec the control plane already
uses); loading one executes the plan's code paths, so treat bundles
with the trust of the cluster that produced them.
"""

from __future__ import annotations

import collections
import hashlib
import os
import pickle
import time
import traceback
from typing import Any, Dict, List, Optional

__all__ = ["record", "ring_events", "capture_bundle", "persist_bundle",
           "persist_reply_forensics", "load_bundle", "replay_bundle",
           "BundleError"]

_MAGIC = "dryad_forensics"
_RING_CAP = int(os.environ.get("DRYAD_FLIGHT_RING", "512"))
# deque.append is atomic under the GIL — safe from sampler threads too
_ring: "collections.deque" = collections.deque(maxlen=_RING_CAP)


class BundleError(RuntimeError):
    """Not a forensics bundle, or one this build cannot replay."""


def record(event: Dict[str, Any]) -> None:
    """Append one event to the process flight ring (bounded; oldest
    events fall off).  Called from the worker's event emit path."""
    _ring.append(event)


def ring_events() -> List[Dict[str, Any]]:
    return list(_ring)


def _digest(obj: Any) -> str:
    """Content digest of a source spec — lets two bundles (or a bundle
    and a live spec) be compared without shipping the data twice."""
    try:
        return hashlib.sha256(
            pickle.dumps(obj, protocol=4)).hexdigest()[:16]
    except Exception:
        return "?"


def capture_bundle(msg: Dict[str, Any], exc: BaseException,
                   kind: str = "task", worker: Optional[int] = None,
                   fn_modules=(), events: Optional[list] = None,
                   device: Optional[str] = None,
                   nparts: Optional[int] = None) -> Dict[str, Any]:
    """Build a forensics bundle from a failing task envelope.

    ``msg`` is the control message being executed (``run_task``);
    ``events`` is the current execution's reply buffer (they are also in
    the ring, but a caller may pass them explicitly when the ring is
    shared with other tasks); ``device`` (a device type, ``"cuda"`` or
    ``"cpu"``) and ``nparts`` are the executing mesh's."""
    sources = msg.get("sources") or {}
    ring = ring_events()
    if events:
        known = {id(e) for e in ring}
        ring += [e for e in events if id(e) not in known]
    return {
        _MAGIC: 1,
        "kind": kind,
        "task": msg.get("task"),
        "job": msg.get("job"),
        "worker": worker,
        "ts": round(time.time(), 4),
        "plan": msg.get("plan"),
        "sources": sources,
        "source_digests": {k: _digest(v) for k, v in sources.items()},
        "config": msg.get("config"),
        "fn_modules": list(fn_modules or ()),
        "nparts": nparts,
        "device": device,
        "error": {"type": type(exc).__name__, "message": str(exc),
                  "traceback": traceback.format_exc()},
        "events": ring,
    }


def persist_bundle(bundle: Dict[str, Any], dir_: str) -> str:
    """Write the bundle under ``dir_``; returns its path."""
    os.makedirs(dir_, exist_ok=True)
    task = bundle.get("task")
    name = (f"{bundle.get('kind', 'task')}"
            f"-job{bundle.get('job', 0)}"
            f"-task{task if task is not None else 'all'}"
            f"-{int(float(bundle.get('ts') or time.time()) * 1000)}"
            f".bundle")
    path = os.path.join(dir_, name)
    with open(path, "wb") as f:
        pickle.dump(bundle, f, protocol=4)
    return path


def persist_reply_forensics(reply: Dict[str, Any], config, event_log,
                            emit) -> Optional[str]:
    """Driver side (shared by runtime/farm.py and the job service's
    cluster fleet): persist a failing reply's bundle and emit the
    ``task_forensics`` breadcrumb through ``emit``.  The bundle lands in
    ``config.forensics_dir``, else a bundles/ dir next to the event
    log's JSONL, else a temp dir (it must always survive the raise).
    Returns the path (None when the reply carries no bundle or
    persisting failed)."""
    from dryad_tpu_torch.runtime import protocol
    bundle = protocol.extract_forensics(reply)
    if bundle is None:
        return None
    dir_ = getattr(config, "forensics_dir", None)
    if not dir_:
        log_path = getattr(event_log, "path", None)
        if log_path:
            dir_ = os.path.join(
                os.path.dirname(os.path.abspath(log_path)), "bundles")
        else:
            import tempfile
            dir_ = tempfile.mkdtemp(prefix="dryad-forensics-")
    try:
        path = persist_bundle(bundle, dir_)
    except Exception:
        return None
    err = bundle.get("error") or {}
    ev = {"event": "task_forensics", "worker": bundle.get("worker"),
          "job": bundle.get("job"), "path": path,
          "error_type": err.get("type"), "error": err.get("message")}
    if bundle.get("task") is not None:
        ev["task"] = bundle["task"]
    try:
        emit(ev)
    except Exception:
        pass
    return path


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        bundle = pickle.load(f)
    if not isinstance(bundle, dict) or not bundle.get(_MAGIC):
        raise BundleError(f"{path} is not a dryad forensics bundle")
    return bundle


def replay_bundle(bundle: Dict[str, Any], mesh=None, device=None):
    """Re-execute the bundled task in-process, as its worker ran it
    (``runtime.worker.run_task``); raises whatever the task raises (the
    reproduction).  Returns the task's PData on (unexpected) success.
    The mesh holds the bundle's partition count on ``device`` (default:
    the device type the task ran on); ``mesh`` overrides both."""
    if not bundle.get("plan"):
        raise BundleError("bundle carries no plan — nothing to replay")
    from dryad_tpu_torch.parallel.mesh import resolve_device
    from dryad_tpu_torch.runtime.worker import run_task, task_executor
    if mesh is None:
        ex = task_executor(resolve_device(device or bundle.get("device")
                                          or "cuda"),
                           int(bundle.get("nparts") or 1))
    else:
        ex = task_executor(mesh.device, mesh.nparts)
    return run_task(bundle, ex, bundle.get("fn_modules") or ())
