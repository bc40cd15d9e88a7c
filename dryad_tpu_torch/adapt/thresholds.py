"""The skew threshold of adaptive execution, with the JAX package's
constant unchanged (``dryad_tpu/adapt/thresholds.py``).

Dependency-free: ``utils/config.py`` imports it for its defaults.
"""

from __future__ import annotations

__all__ = ["SKEW_SIBLING_MEDIAN_FACTOR", "sibling_median", "skew_ratio"]

# a partition is SKEWED when it holds at least this multiple of the
# median of its sibling partitions' row counts (Dryad's
# DrDynamicDistributionManager splits a part that exceeds its per-bucket
# target the same relative way)
SKEW_SIBLING_MEDIAN_FACTOR = 4.0


def sibling_median(rows) -> int:
    """Median of ``rows`` without the peak entry: the denominator of the
    skew ratio."""
    rows = [int(r) for r in rows]
    if len(rows) < 2:
        return rows[0] if rows else 0
    peak_i = rows.index(max(rows))
    sib = sorted(r for i, r in enumerate(rows) if i != peak_i)
    return sib[len(sib) // 2]


def skew_ratio(rows) -> float:
    """peak / sibling median (>= 1.0); 1.0 for fewer than two rows."""
    rows = [int(r) for r in rows]
    if len(rows) < 2:
        return 1.0
    return max(rows) / max(sibling_median(rows), 1)
