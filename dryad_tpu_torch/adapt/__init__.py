"""Adaptive execution: stage-boundary graph rewriting — the port of
``dryad_tpu/adapt``.

Dryad's connection managers rewrite the running job graph from measured
vertex output sizes (``DrDynamicAggregateManager``,
``DrDynamicDistributionManager``, ``DrDynamicBroadcastManager``).  Here
the same three rules act on the not-yet-executed stages of a
``StageGraph``:

* ``adapt/thresholds.py`` — the skew constant and its two helpers;
* ``adapt/stats.py`` — a materialized stage's measured rows and bytes;
* ``adapt/rewrite.py`` — the mutation window over the unexecuted
  stages, with stable stage ids;
* ``adapt/rules.py`` — the three connection managers;
* ``adapt/manager.py`` — the boundary driver ``exec/recovery.Run``
  calls after each stage it materializes.

``JobConfig(adaptive="on")`` turns it on; off (the default) builds
nothing and runs the plan as planned.  This ``__init__`` imports only
the thresholds: ``utils/config.py`` imports them at module load.
"""

from dryad_tpu_torch.adapt.thresholds import (SKEW_SIBLING_MEDIAN_FACTOR,
                                              sibling_median, skew_ratio)

__all__ = ["SKEW_SIBLING_MEDIAN_FACTOR", "sibling_median", "skew_ratio"]
