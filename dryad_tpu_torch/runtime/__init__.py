"""The port of ``dryad_tpu/runtime``, so far only the pure helpers of
``shiplan.py`` that the job service's in-process plan cache uses.  The
cluster runtime (the worker gang, the task farm, the cluster's streamed
runtime) comes with ROADMAP Queue 1 item 11."""
