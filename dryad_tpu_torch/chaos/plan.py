"""Seeded, deterministic fault plans — the port of
``dryad_tpu/chaos/plan.py``: every seed gives the JAX package's plan.

Every scenario decision — when to kill the victim, whether to tear the
journal tail afterwards, how the victim sizes its stores — is derived
from one integer seed through ``random.Random``.  The same seed always
produces the same plan, so a failing run is reproducible with
``python -m dryad_tpu_torch.chaos --seed N`` and nothing else.

(The OS still schedules threads; what the plan pins down is the
*trigger*: the kill fires when the target job's event log shows
``kill_after_spills`` settled-and-spilled stages, not after a wall-clock
sleep.)
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict

__all__ = ["FaultPlan"]


class FaultPlan:
    """The deterministic scenario derived from ``seed``.

    * ``kill_after_spills`` — SIGKILL the victim once its target job
      has journaled this many ``stage_spilled`` events (the job is then
      provably PAST a settled stage, so recovery must restore — not
      recompute — that work).
    * ``torn_tail`` / ``torn_bytes`` — after the kill, append a partial
      journal record (a torn write): recovery must truncate it and
      proceed, never refuse.
    * ``store_rows`` / ``store_keys`` — victim dataset shape, varied so
      different seeds exercise different plan shapes and timings.
    """

    def __init__(self, seed: int = 0):
        rng = random.Random(int(seed))
        self.seed = int(seed)
        self.kill_after_spills = rng.choice((1, 1, 2))
        self.torn_tail = rng.random() < 0.5
        self.torn_bytes = rng.randint(8, 120)
        self.store_rows = 24000 + 512 * rng.randint(0, 15)
        self.store_keys = rng.choice((256, 512, 1024))
        self.standing_period_s = round(0.2 + 0.1 * rng.random(), 3)

    def to_json(self) -> Dict[str, Any]:
        return dict(vars(self))

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FaultPlan":
        plan = cls(int(obj.get("seed", 0)))
        for k, v in obj.items():
            setattr(plan, k, v)
        return plan

    def __repr__(self) -> str:
        return f"FaultPlan({json.dumps(self.to_json(), sort_keys=True)})"
