"""A materialized stage's measured output, as the connection managers
read it — the port of ``dryad_tpu/adapt/stats.py``.

The executor reads each synchronous attempt's info vector (the output's
rows per partition among it) back anyway; ``StageStats`` is that
measurement with the output's capacity and static bytes: Dryad's
vertex-completion size reports (``NotifyUpstreamVertexCompleted``),
measured, not estimated.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from dryad_tpu_torch.adapt.thresholds import sibling_median, skew_ratio

__all__ = ["StageStats"]


@dataclasses.dataclass(frozen=True)
class StageStats:
    """``rows``: valid rows per partition; ``capacity``: the output's
    per-partition capacity; ``out_bytes``: its bytes on the device.  A
    rule treats absent evidence as unknown, never as balanced."""

    stage: int
    rows: Tuple[int, ...]
    capacity: int = 0
    out_bytes: int = 0
    wall_s: float = 0.0

    @property
    def total_rows(self) -> int:
        return int(sum(self.rows))

    @property
    def peak_rows(self) -> int:
        return int(max(self.rows)) if self.rows else 0

    @property
    def sibling_median(self) -> int:
        return sibling_median(self.rows)

    @property
    def skew_ratio(self) -> float:
        return skew_ratio(self.rows)

    def is_skewed(self, factor: float) -> bool:
        """peak >= factor x sibling median, and at least two rows on the
        peak partition."""
        return self.peak_rows >= 2 and self.skew_ratio >= factor

    def event(self) -> dict:
        """The ``adapt_stats`` event payload."""
        return {"event": "adapt_stats", "stage": self.stage,
                "rows": list(self.rows), "capacity": self.capacity,
                "out_bytes": self.out_bytes,
                "skew_ratio": round(self.skew_ratio, 2)}
