"""Per-job driver-state snapshots, written at stage boundaries — the port
of ``dryad_tpu/service/durable/checkpoint.py``.

The spill dir already makes stage OUTPUTS durable (exec/recovery.Run
``_save_spill`` + restart-stable ``.fp`` fingerprints); what it does
not capture is the DRIVER's view of the run — which stages settled,
how much failure budget remains, which adaptive rewrites fired, and
the last observed-stats box.  ``JobCheckpoint`` snapshots exactly that
into ``<job_dir>/checkpoint.json`` (rename-commit, utils/atomic.py)
every time a stage materializes, so recovery can tell a resumable job
("settled stages 0-3, spill present — re-execute only the rest") from
one whose lineage is gone, and the handoff protocol has a defined
"checkpointed stage boundary" to pause at.

The object is the ``checkpoint=`` hook exec/recovery.Run calls as
``ckpt(run, sid)`` after each stage boundary — it reads only public
run state and must never fail the run.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

from dryad_tpu_torch.utils.atomic import atomic_write_json

__all__ = ["JobCheckpoint"]


class JobCheckpoint:
    """Stage-boundary driver snapshot for one job (see module doc)."""

    def __init__(self, path: str, job: Optional[str] = None):
        self.path = path
        self.job = job

    def __call__(self, run, sid: int) -> None:
        try:
            stats = run._stats_box[0]
            snap = {
                "job": self.job, "ts": round(time.time(), 4),
                "stage": sid,
                "settled": sorted(run._results),
                "failures": run.failures,
                "budget_left": max(0, run.failure_budget - run.failures),
                "rewrites": ([dict(e) for e in run.adapt.applied]
                             if run.adapt is not None else []),
                "stats": (stats.__dict__ if stats is not None
                          and sid == getattr(stats, "stage", None)
                          else None),
                "spill_dir": run.spill_dir,
            }
            atomic_write_json(self.path, snap, default=str)
        except Exception:
            pass      # a snapshot must never fail the run it observes

    @staticmethod
    def load(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None
