"""Static analysis — the port's part of ``dryad_tpu/analysis`` so far:
the diagnostics (``analysis/diagnostics.py``) and the static cost model
(``analysis/domain.py``, ``analysis/cost.py``).  The plan verifier, the
UDF lint and the pre-submit gate come with ROADMAP Queue 1 item 10."""
