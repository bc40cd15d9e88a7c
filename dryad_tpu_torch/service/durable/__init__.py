"""Durable job service — the port of ``dryad_tpu/service/durable``:
the write-ahead journal of the daemon's own state (``journal.py``, the
JAX package's record format), the per-job driver snapshots taken at
stage boundaries (``checkpoint.py``), and the recovery pass that
re-admits queued jobs in their original order and resumes running ones
from lineage and spill (``recover.py``).  ``JobService.handoff`` lets a
successor daemon adopt the journal mid-flight.
"""

from dryad_tpu_torch.service.durable.checkpoint import JobCheckpoint
from dryad_tpu_torch.service.durable.journal import (JOURNAL_VERSION,
                                                     Journal, JournalError,
                                                     ReplayState)
from dryad_tpu_torch.service.durable.recover import recover

__all__ = ["Journal", "JournalError", "JobCheckpoint", "ReplayState",
           "JOURNAL_VERSION", "recover"]
