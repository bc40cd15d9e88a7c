"""Incremental execution: queries over growing stores — the port of
``dryad_tpu/inc`` (its service-resident scheduler, ``standing.py``,
comes with the service).

A batch SELECT over a store becomes a standing query (``EMIT EVERY``):
append-aware manifests (``io/store.py`` generations) scope each refresh's
scan to the partitions appended since the committed watermark, and a plan
whose aggregate suffix is decomposable merges the refresh's partial into
persisted per-group state instead of rescanning the store.

* :mod:`dryad_tpu_torch.inc.delta_plan` — the static verdict (DTA4xx):
  does the suffix merge, and how do the state columns finalize into the
  query's outputs?
* :mod:`dryad_tpu_torch.inc.state` — the atomic state + watermark commit
  (one ``os.replace``).
* :mod:`dryad_tpu_torch.inc.refresh` — one refresh: the delta scan
  through the normal SQL lowering on the context's device, the merge on
  the host, finalize, commit.
"""

from dryad_tpu_torch.inc.delta_plan import DeltaPlan, plan_delta
from dryad_tpu_torch.inc.refresh import RefreshResult, run_refresh

__all__ = ["DeltaPlan", "plan_delta", "RefreshResult", "run_refresh"]
