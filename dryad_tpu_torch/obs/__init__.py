"""Observability — the port's part of ``dryad_tpu/obs`` so far: the
metrics registry (``obs/metrics.py``)."""
