"""Chaos harness for the durable job service — the port of the JAX
package's ``chaos/``.

Kills a real daemon process (SIGKILL, no grace) at a seeded point in a
fleet of in-flight jobs, optionally tears the journal tail the way a
power cut mid-append would, restarts a successor daemon over the same
service dir, and checks the durability invariants:

* **zero lost jobs** — every job the dead daemon ever admitted reaches
  a terminal state on the successor (done, failed-with-forensics, or
  superseded — never silently missing);
* **exactly-once terminal** — no job is journaled terminal twice (the
  tenant fair-share ledger is charged at most once per job);
* **oracle-identical results** — a recovered job's result equals a
  fresh same-query run on the successor.

Runnable: ``python -m dryad_tpu_torch.chaos [--seed N] [--device cpu]``
(the daemons run on the CUDA card by default).
"""

from dryad_tpu_torch.chaos.harness import run_scenario
from dryad_tpu_torch.chaos.invariants import (check_invariants,
                                              exactly_once_terminal,
                                              read_state, zero_lost_jobs)
from dryad_tpu_torch.chaos.plan import FaultPlan

__all__ = ["FaultPlan", "run_scenario", "check_invariants",
           "read_state", "exactly_once_terminal", "zero_lost_jobs"]
