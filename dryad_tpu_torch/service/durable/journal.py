"""Write-ahead journal for the job service's own state — the port of
``dryad_tpu/service/durable/journal.py``, with its record format.

Append-only JSONL under ``<service_dir>/durable/``: every admission,
queue entry, dispatch, terminal transition, tenant fair-share charge,
and standing-query registration is one record, fsynced before the
daemon acts on it.  Periodic CHECKPOINT COMPACTION folds the journal
into ``checkpoint.json`` (committed with the tree-wide rename-commit
helper, utils/atomic.py) and truncates the log — recovery is always
"load checkpoint, replay the short journal suffix".

Crash tolerance is asymmetric by design:

* a TORN TAIL (the crash landed mid-append) is normal — the partial
  last record is truncated away and replay proceeds;
* garbage anywhere ELSE, an unreadable checkpoint, or a journal format
  version this code does not speak is real corruption — a typed
  :class:`JournalError` (``DTA914``) refusing recovery, never a silent
  partial restore.

Records use the ``"rec"`` key (not ``"event"``) — the journal is
durable state, not an event stream; the observable recovery events
(``journal_replay``/``job_resumed``/...) are emitted by recover.py
into the normal event logs.

Replay is a pure fold (:func:`replay_records` over :class:`ReplayState`);
the live journal keeps its own folded mirror in step with every append,
so compaction writes the exact state a fresh replay would produce.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dryad_tpu_torch.analysis.diagnostics import DiagnosticError
from dryad_tpu_torch.utils.atomic import atomic_write_json

__all__ = ["Journal", "JournalError", "ReplayState", "JOURNAL_VERSION",
           "TERMINAL_STATES"]

# journal FORMAT version: bumped only when the record schema changes
# incompatibly.  Distinct from the package version (which rolls every
# release and MAY differ across a rolling upgrade — that is the point
# of the handoff protocol; plan-cache salting handles stale lowerings).
JOURNAL_VERSION = 1

# a job in one of these phases needs no recovery action
TERMINAL_STATES = ("done", "failed", "cancelled", "rejected")


class JournalError(DiagnosticError):
    """Corrupt journal / unreadable checkpoint / format-version
    mismatch — recovery is REFUSED with the stable DTA914 code rather
    than silently restoring a partial state."""

    def __init__(self, message: str):
        super().__init__(message, code="DTA914")


class ReplayState:
    """The fold target: everything recovery needs to rebuild the
    daemon.  ``jobs`` maps job id -> ``{"spec": .., "phase": ..,
    "error": ..}`` in admission order (dict insertion order; specs
    carry the original ``seq`` so fair-share order survives exactly)."""

    def __init__(self):
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.tenants: Dict[str, Dict[str, float]] = {}
        self.standing: Dict[str, Dict[str, Any]] = {}
        self.seq = 0                  # high-water job sequence number
        self.counter = 0              # high-water record number
        self.clean = False            # last epoch ended with a close
        self.handoff: Optional[Dict[str, Any]] = None
        self.epochs = 0
        self.dup_terminals: List[str] = []   # exactly-once violations
        self.torn = False             # a torn tail was truncated

    # -- folding -----------------------------------------------------------

    def fold(self, r: Dict[str, Any]) -> None:
        self.counter = max(self.counter, int(r.get("n", 0)))
        k = r.get("rec")
        if k == "open":
            self.epochs += 1
            self.clean = False
            self.handoff = None
        elif k == "close":
            self.clean = True
        elif k == "handoff_ready":
            self.handoff = {"ver": r.get("ver"), "ts": r.get("ts")}
        elif k == "job_admitted":
            spec = r["spec"]
            self.jobs.setdefault(spec["id"],
                                 {"spec": spec, "phase": "admitted",
                                  "error": None})
            self.jobs[spec["id"]]["spec"] = spec
            self.seq = max(self.seq, int(spec.get("seq", 0)))
        elif k in ("job_queued", "job_dispatched"):
            j = self.jobs.setdefault(r["id"], {"spec": None,
                                               "phase": "admitted",
                                               "error": None})
            if j["phase"] not in TERMINAL_STATES:
                j["phase"] = ("queued" if k == "job_queued"
                              else "running")
        elif k == "job_terminal":
            j = self.jobs.setdefault(r["id"], {"spec": None,
                                               "phase": "admitted",
                                               "error": None})
            if j["phase"] in TERMINAL_STATES:
                self.dup_terminals.append(r["id"])
            else:
                j["phase"] = r["state"]
                j["error"] = r.get("error")
                j["wall_s"] = r.get("wall_s")
        elif k == "tenant_charge":
            t = self.tenants.setdefault(r["tenant"],
                                        {"used_slot_s": 0.0,
                                         "failures": 0})
            t["used_slot_s"] += max(0.0, float(r.get("wall_s", 0.0)))
            if not r.get("ok", True):
                t["failures"] += 1
        elif k == "standing_registered":
            self.standing[r["reg"]["id"]] = r["reg"]
        elif k == "standing_cancelled":
            self.standing.pop(r["id"], None)
        # unknown record kinds are skipped: a NEWER minor writer may add
        # informational records; incompatible changes bump the version

    def live_jobs(self) -> List[Dict[str, Any]]:
        """Non-terminal jobs in original admission (seq) order."""
        live = [dict(j, id=jid) for jid, j in self.jobs.items()
                if j["phase"] not in TERMINAL_STATES]
        live.sort(key=lambda j: (j["spec"] or {}).get("seq", 0))
        return live

    # -- checkpoint serialization ------------------------------------------

    def to_checkpoint(self, max_terminal: int = 4096) -> Dict[str, Any]:
        jobs = dict(self.jobs)
        term = [jid for jid, j in jobs.items()
                if j["phase"] in TERMINAL_STATES]
        # bound checkpoint growth: drop the OLDEST terminal rows beyond
        # the cap (their job dirs/history archives remain on disk)
        for jid in term[:max(0, len(term) - max_terminal)]:
            del jobs[jid]
        return {"journal_version": JOURNAL_VERSION,
                "counter": self.counter, "seq": self.seq,
                "jobs": jobs, "tenants": self.tenants,
                "standing": self.standing}

    @classmethod
    def from_checkpoint(cls, obj: Dict[str, Any]) -> "ReplayState":
        if obj.get("journal_version") != JOURNAL_VERSION:
            raise JournalError(
                f"service journal checkpoint has format version "
                f"{obj.get('journal_version')!r}, this daemon speaks "
                f"{JOURNAL_VERSION} — refusing recovery")
        st = cls()
        st.counter = int(obj.get("counter", 0))
        st.seq = int(obj.get("seq", 0))
        st.jobs = dict(obj.get("jobs") or {})
        st.tenants = dict(obj.get("tenants") or {})
        st.standing = dict(obj.get("standing") or {})
        return st


def _read_records(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    """Parse the journal JSONL tolerantly: a torn TAIL record (crash
    mid-append) is physically truncated away and flagged; garbage
    before the tail is corruption (JournalError/DTA914)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], False
    records: List[Dict[str, Any]] = []
    torn = False
    off = 0
    while off < len(data):
        nl = data.find(b"\n", off)
        end = nl if nl >= 0 else len(data)
        line = data[off:end]
        try:
            rec = json.loads(line.decode("utf-8"))
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except (ValueError, UnicodeDecodeError):
            if nl >= 0 and data[end + 1:].strip():
                raise JournalError(
                    f"service journal {path} is corrupt at byte {off} "
                    f"(garbage before the tail) — refusing recovery")
            # torn tail: truncate it so later appends start clean
            with open(path, "r+b") as f:
                f.truncate(off)
            torn = True
            break
        records.append(rec)
        if nl < 0:
            break
        off = nl + 1
    return records, torn


class Journal:
    """The live write-ahead journal (see module docstring).

    Opening a journal REPLAYS what is on disk first: the folded
    :class:`ReplayState` is exposed as ``self.recovered`` for
    recover.py, and the journal continues appending from the recovered
    record counter.  Every append also folds into the live mirror so
    :meth:`compact` can checkpoint without re-reading the file."""

    def __init__(self, dirpath: str, fsync: bool = True,
                 compact_every: int = 512, version: Optional[str] = None):
        import dryad_tpu_torch
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.path = os.path.join(dirpath, "journal.jsonl")
        self.ckpt_path = os.path.join(dirpath, "checkpoint.json")
        self.lock_path = os.path.join(dirpath, "LOCK")
        self.fsync = fsync
        self.compact_every = max(8, int(compact_every))
        self.version = (version if version is not None
                        else getattr(dryad_tpu_torch, "__version__", "dev"))
        self._lock = threading.Lock()
        self._since_compact = 0
        self.closed = False
        # advisory ownership: last writer wins (a rolling upgrade has
        # BOTH daemons alive during adoption); the previous owner is
        # surfaced so recovery can log it, never a hard refusal
        self.prior_owner = self._take_lock()
        self.recovered = self._replay()
        self._state = self.recovered
        # the "open" append below folds into the live mirror (which
        # ALIASES ``recovered``) and resets the epoch flags — snapshot
        # what recovery needs to see about the PREVIOUS epoch first
        self.was_clean = self.recovered.clean
        self.was_handoff = self.recovered.handoff
        self.was_torn = self.recovered.torn
        self._f = open(self.path, "a")
        self._n = self.recovered.counter
        self._append("open", journal_version=JOURNAL_VERSION,
                     ver=self.version, pid=os.getpid())

    # -- ownership ---------------------------------------------------------

    def _take_lock(self) -> Optional[Dict[str, Any]]:
        prior = None
        try:
            with open(self.lock_path) as f:
                prior = json.load(f)
        except (OSError, ValueError):
            prior = None
        if prior is not None:
            pid = prior.get("pid")
            try:
                alive = (isinstance(pid, int) and pid != os.getpid()
                         and (os.kill(pid, 0) or True))
            except OSError:
                alive = False
            prior = dict(prior, alive=alive)
        atomic_write_json(self.lock_path,
                          {"pid": os.getpid(), "ts": time.time(),
                           "ver": self.version})
        return prior

    def _release_lock(self) -> None:
        try:
            with open(self.lock_path) as f:
                if json.load(f).get("pid") != os.getpid():
                    return           # a successor already took over
        except (OSError, ValueError):
            return
        try:
            os.unlink(self.lock_path)
        except OSError:
            pass

    # -- replay ------------------------------------------------------------

    def _replay(self) -> ReplayState:
        if os.path.exists(self.ckpt_path):
            try:
                with open(self.ckpt_path) as f:
                    obj = json.load(f)
            except (OSError, ValueError) as e:
                raise JournalError(
                    f"service journal checkpoint {self.ckpt_path} is "
                    f"unreadable ({e!r}) — refusing recovery")
            state = ReplayState.from_checkpoint(obj)
        else:
            state = ReplayState()
        records, torn = _read_records(self.path)
        for r in records:
            if r.get("rec") == "open" \
                    and r.get("journal_version") != JOURNAL_VERSION:
                raise JournalError(
                    f"service journal {self.path} was written with "
                    f"format version {r.get('journal_version')!r}, "
                    f"this daemon speaks {JOURNAL_VERSION} — refusing "
                    f"recovery")
            # records folded into the checkpoint already (crash between
            # checkpoint write and journal truncate) must not re-charge
            # tenants — the record counter is globally monotone
            if int(r.get("n", 0)) > state.counter:
                state.fold(r)
        state.torn = torn
        return state

    # -- appends -----------------------------------------------------------

    def _append(self, rec: str, **fields: Any) -> None:
        with self._lock:
            if self.closed:
                return
            self._n += 1
            r = dict(fields, rec=rec, n=self._n,
                     ts=round(time.time(), 4))
            self._f.write(json.dumps(r) + "\n")
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._state.fold(r)
            self._since_compact += 1
            if self._since_compact >= self.compact_every:
                self._compact_locked()

    def job_admitted(self, spec: Dict[str, Any]) -> None:
        self._append("job_admitted", spec=spec)

    def job_queued(self, jid: str, seq: int) -> None:
        self._append("job_queued", id=jid, seq=seq)

    def job_dispatched(self, jid: str) -> None:
        self._append("job_dispatched", id=jid)

    def job_terminal(self, jid: str, state: str,
                     error: Optional[str] = None,
                     wall_s: Optional[float] = None) -> None:
        self._append("job_terminal", id=jid, state=state,
                     error=(error or None) and str(error)[:2000],
                     wall_s=wall_s)

    def tenant_charge(self, tenant: str, wall_s: float,
                      ok: bool = True) -> None:
        self._append("tenant_charge", tenant=tenant,
                     wall_s=round(float(wall_s), 6), ok=bool(ok))

    def standing_registered(self, reg: Dict[str, Any]) -> None:
        self._append("standing_registered", reg=reg)

    def standing_cancelled(self, sid: str) -> None:
        self._append("standing_cancelled", id=sid)

    def handoff_ready(self, ver: Optional[str] = None) -> None:
        self._append("handoff_ready", ver=ver or self.version)

    # -- compaction --------------------------------------------------------

    def compact(self, max_terminal: int = 4096) -> None:
        with self._lock:
            if not self.closed:
                self._compact_locked(max_terminal)

    def _compact_locked(self, max_terminal: int = 4096) -> None:
        """Checkpoint-then-truncate (holds the lock).  Crash-safe in
        both orders: the checkpoint lands atomically and carries the
        record counter, so replay skips journal records it already
        folded (crash between the two steps double-applies nothing)."""
        atomic_write_json(self.ckpt_path,
                          self._state.to_checkpoint(max_terminal))
        self._f.close()
        self._f = open(self.path, "w")
        self._since_compact = 0
        # re-bookend the fresh epoch so a bare journal still declares
        # its format version
        self._n += 1
        r = {"rec": "open", "n": self._n,
             "journal_version": JOURNAL_VERSION, "ver": self.version,
             "pid": os.getpid(), "ts": round(time.time(), 4),
             "compacted": True}
        self._f.write(json.dumps(r) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._state.fold(r)

    # -- lifecycle ---------------------------------------------------------

    def close(self, clean: bool = True, release_lock: bool = True) -> None:
        if self.closed:
            return
        if clean:
            self._append("close")
        with self._lock:
            self.closed = True
            self._f.close()
        if release_lock:
            self._release_lock()
