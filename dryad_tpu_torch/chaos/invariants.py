"""Durability invariant checkers — the port of
``dryad_tpu/chaos/invariants.py``.

These read the journal the same way daemon recovery does (checkpoint +
suffix replay) but WITHOUT opening a new epoch — pure observers a test
or the chaos harness can point at any service dir, live or dead.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from dryad_tpu_torch.service.durable.journal import (ReplayState,
                                                     TERMINAL_STATES,
                                                     _read_records)

__all__ = ["read_state", "zero_lost_jobs", "exactly_once_terminal",
           "oracle_identical", "check_invariants"]


def read_state(durable_dir: str) -> ReplayState:
    """Fold checkpoint + journal of ``<service_dir>/durable`` into a
    ReplayState, read-only (no truncation side effects are needed here
    because ``_read_records`` only truncates a torn tail — which is
    exactly what recovery would do anyway)."""
    import json
    ckpt = os.path.join(durable_dir, "checkpoint.json")
    if os.path.exists(ckpt):
        with open(ckpt) as f:
            state = ReplayState.from_checkpoint(json.load(f))
    else:
        state = ReplayState()
    records, torn = _read_records(os.path.join(durable_dir,
                                               "journal.jsonl"))
    for r in records:
        if int(r.get("n", 0)) > state.counter:
            state.fold(r)
    state.torn = torn
    return state


def zero_lost_jobs(state: ReplayState) -> List[str]:
    """Ids admitted but never driven to a terminal state — must be
    empty once the successor daemon has drained the recovered fleet.
    (A job the successor could not rebuild still terminates: it fails
    with forensics, which IS a terminal record.)"""
    return [jid for jid, j in state.jobs.items()
            if j["phase"] not in TERMINAL_STATES]


def exactly_once_terminal(state: ReplayState) -> List[str]:
    """Ids journaled terminal more than once — must be empty, or a
    tenant could be charged twice for one job."""
    return list(state.dup_terminals)


def oracle_identical(results: Dict[str, Any],
                     oracle: Any) -> List[str]:
    """Recovered-job results that diverge from the fresh oracle run."""
    return [jid for jid, res in results.items() if res != oracle]


def check_invariants(durable_dir: str,
                     results: Optional[Dict[str, Any]] = None,
                     oracle: Any = None) -> Dict[str, Any]:
    """The full verdict the chaos harness asserts on."""
    state = read_state(durable_dir)
    lost = zero_lost_jobs(state)
    dups = exactly_once_terminal(state)
    diverged = (oracle_identical(results, oracle)
                if results is not None else [])
    return {"jobs": len(state.jobs), "epochs": state.epochs,
            "torn": state.torn, "lost": lost, "dup_terminals": dups,
            "diverged": diverged,
            "ok": not (lost or dups or diverged)}
